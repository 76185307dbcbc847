"""numpy model of the order in which kernel D's pass 2
(``pumipic_torch/kernels/csrc/deposit.cu``) adds each output vertex's
gyro-map entries: ``GROUP`` lanes per vertex, lane l adding the entries l,
l + G, l + 2G, ... of the vertex's CSR list in that order, each value
divided by P, then the lanes added by a fixed tree (lane l += lane l + d
for d = G/2, ..., 1).  All in f32, as the kernel."""
import numpy as np

GROUP = 8  # deposit.cu's DEPOSIT_GROUP


def mapped_group_order(ring_accum, offsets, src, points_per_ring: int,
                       group: int = GROUP) -> np.ndarray:
    vals = np.asarray(ring_accum, np.float32).reshape(-1)
    off = np.asarray(offsets, np.int64)
    src = np.asarray(src, np.int64)
    V = off.size - 1
    lanes = np.zeros((V, group), np.float32)
    p = np.float32(points_per_ring)
    longest = int(np.diff(off).max()) if V else 0
    for k in range(-(-longest // group)):
        j = off[:-1, None] + k * group + np.arange(group)
        ok = j < off[1:, None]
        term = vals[src[np.where(ok, j, 0)]] / p
        lanes = np.where(ok, lanes + term, lanes)
    d = group // 2
    while d >= 1:
        lanes[:, :d] = lanes[:, :d] + lanes[:, d:2 * d]
        d //= 2
    return lanes[:, 0]
