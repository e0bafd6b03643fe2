"""What the persistent-grid kernels share on the Python side
(``csrc/grid_sync.cuh``): the card's limits their plans are sized by (the
SM count read from the device), each stream's grid barrier counters, and a
torch model of the fixed-order sum across blocks.

Used by the GroupNorm + swish backward (``ops/gn_swish_bwd.py``) and the
LayerNorm backward (``ops/layer_norm.py``), each one cooperative launch
whose blocks are all resident, meet at grid barriers and reduce across
blocks without float atomics.
"""

from __future__ import annotations

SMS = 132                 # an H100 SXM's SMs: the plans' default, for the CPU tests
SMEM_BLOCK_MAX = 232448   # dynamic shared memory one block may have
SMEM_SM = 233472          # shared memory of an SM; each resident block also takes 1 KB
THREADS_SM = 2048

_COUNTERS = {}
_DEVICE_SMS = {}


def device_sms(device) -> int:
    """The streaming multiprocessors of the CUDA `device` (an H100 SXM has
    132, an H100 PCIe 114), read once a device: the callers size their
    persistent grids by it, so that every block is resident."""
    import torch

    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    sms = _DEVICE_SMS.get(index)
    if sms is None:
        sms = _DEVICE_SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return sms


def blocks_per_sm(smem: int, threads: int) -> int:
    """Blocks of `threads` threads and `smem` bytes of shared memory that one
    SM holds (registers aside: the kernels' launch bounds keep them in)."""
    return min(THREADS_SM // threads, SMEM_SM // (smem + 1024))


def grid_counters(device):
    """The grid barrier's counters of the current stream on `device`: an
    int64 buffer of 32 words, zero when made (once a stream), whose words 0
    and 16 the kernels count arrivals on.  Each call leaves their low 32
    bits at zero, so a stream's calls run back to back on them; calls on
    another stream get its own."""
    import torch

    stream = torch.cuda.current_stream(device)
    key = (stream.device_index, stream.cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None:
        buf = torch.zeros(32, dtype=torch.int64, device=device)
        _COUNTERS[key] = buf
    return buf


def column_runs(parts: int, cols: int, threads: int) -> list:
    """The runs ``ordered_column_sum`` splits each column's parts into when
    `threads` threads sum `cols` columns: [(first part, end)] in lane order
    (a power of two of them, some empty, or one run of all parts where cols
    * 2 > threads)."""
    if cols * 2 > threads:
        return [(0, parts)]
    tpc = 1
    while tpc * 2 * cols <= threads:
        tpc *= 2
    n = -(-parts // tpc)
    return [(min(parts, r * n), min(parts, (r + 1) * n)) for r in range(tpc)]


def ordered_column_sum(part, threads: int):
    """Model of ``csrc/grid_sync.cuh:ordered_column_sum`` over a (parts,
    cols) float32 tensor: each run's parts added in ascending order from
    zero, the runs of a warp (32 at most) by the butterfly's tree (pairs of
    neighbours, then pairs of pairs), then the warps' sums in order from
    zero, all in float32 -> (cols,)."""
    import torch

    parts, cols = part.shape
    sums = []
    for p0, p1 in column_runs(parts, cols, threads):
        acc = torch.zeros(cols, dtype=torch.float32)
        for p in range(p0, p1):
            acc = acc + part[p].float()
        sums.append(acc)
    warps = []
    for w0 in range(0, len(sums), 32):
        tree = sums[w0:w0 + 32]
        while len(tree) > 1:
            tree = [tree[i] + tree[i + 1] for i in range(0, len(tree), 2)]
        warps.append(tree[0])
    if len(warps) == 1:
        return warps[0]
    total = torch.zeros(cols, dtype=torch.float32)
    for w in warps:
        total = total + w
    return total
