"""Write the production-class XGC-like tokamak mesh with the port alone.

``tokamak_mesh(340, 1750)`` (981,178 triangles, 491,770 vertices: the 120k
mesh's generator arguments (120, 620) scaled by ~sqrt(8)) written as a
gzip'd gmsh file, ``chip_tree/xgc_like_1M.msh.gz`` by default, so that the
file ingestion path (``read_msh``) feeds the runs at production size.  The
file is made at run time and never committed; an existing one is reused.
``bench_torch.py`` (``BENCH_MESH=chip_tree/xgc_like_1M.msh.gz``) and
``chip_smoke.py`` make it themselves at first use.

Usage:  python3 scripts/make_xgc_mesh_torch.py [out_path]
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import bench_torch  # noqa: E402


def main() -> None:
    path = sys.argv[1] if len(sys.argv) > 1 else bench_torch.PRODUCTION_MESH
    t0 = time.perf_counter()
    made = not os.path.exists(path)
    bench_torch.production_mesh(os.path.abspath(path))
    print(f"{path}: {'written' if made else 'reused'} in {time.perf_counter() - t0:.1f} s, "
          f"{os.path.getsize(path) / 1e6:.2f} MB")


if __name__ == "__main__":
    main()
