"""W8A16 matmul: ``x [..., K] @ (w_q [K, N] int8) * scale [N]``.

Counterpart of ``llmspeculativesampling_tpu/kernels/int8_matmul.py``. The
TPU kernel it replaces is ``_int8_matmul_2d`` (``pl.pallas_call`` with body
``_kernel``); on Hopper it is ``csrc/int8_matmul.cu``: a tensor-core kernel
(``wgmma`` with the widened int8 weights as the register operand and x from
shared memory) that reads each weight byte once for every M <= 256. Its
header says what bounds it at each path's M. :func:`plan` picks the row
tile (the ``wgmma`` N) and the split of K for a call.

:func:`int8_matmul` launches the CUDA kernel for a CUDA tensor, or raises;
:func:`int8_matmul_ref`, the plain PyTorch version, serves CPU tensors and
is the oracle the kernel is held against. ``int8_matmul.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

BN, BK = 128, 64  # weight columns of a block, k-rows of a pipeline chunk
MTS = (8, 16, 32, 64, 128, 160, 256)  # row tiles the kernel is built for (the wgmma N)
SMS = 132  # H100 SXM
WS_CAP = 16 << 20  # bytes of split-K partials, well inside the 50 MB L2
FILL = 3  # chunks' worth of time a block spends before its ring is full
# rows of one prompt bucket: a batch-invariant call splits K as an M=64 call does
INVARIANT_M = 64


def blocks_per_sm(mt: int) -> int:
    """Blocks of row tile ``mt`` resident on one SM (the kernel's
    ``Cfg<MT>::MIN_BLOCKS``)."""
    return 2 if mt <= 160 else 1


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def int8_matmul_ref(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version: bf16(x) @ widen(w_q) with exact products and fp32
    sums, times the per-column scale, cast to x's dtype."""
    y = x.to(torch.bfloat16).float() @ w_q.float()
    return (y * scale.float()[None, :]).to(x.dtype)


@functools.lru_cache(maxsize=None)
def plan(m: int, k: int, n: int, batch_invariant: bool = False):
    """(row tile MT, ksplit, chunks per split) for an [m, k] x [k, n] call.

    MT is the smallest built tile that covers m, or m split evenly over
    ceil(m/256) tiles, so every m <= 256 reads each weight byte once. K is
    split into ``ksplit`` ranges of whole 64-row chunks: at least one block
    per SM where the column tiles and chunks allow it within the workspace
    cap, and among those the least ``waves * (chunks per block + FILL)``,
    FILL standing for a block's start: its first copies in flight.

    A row's sums depend on the split of K, and the row tile does not change
    them. ``batch_invariant=True`` takes the split an ``INVARIANT_M``-row
    call gets, chosen from (K, N) alone, so a row's output is the same
    bits however many rows share the call (the paged engine's admission
    prefill, whose M is 64 times the requests admitted together)."""
    m_tiles = _cdiv(m, MTS[-1])
    mt = next(t for t in MTS if t >= _cdiv(m, m_tiles))
    if batch_invariant and m != INVARIANT_M:
        return (mt, *plan(INVARIANT_M, k, n)[1:])
    tiles = _cdiv(n, BN) * _cdiv(m, mt)
    chunks = _cdiv(k, BK)
    slots = SMS * blocks_per_sm(mt)
    options = {}  # ksplit -> chunks per split
    for want in range(1, chunks + 1):
        cps = _cdiv(chunks, want)
        ksplit = _cdiv(chunks, cps)
        if ksplit > 1 and ksplit * m * n * 4 > WS_CAP:
            break
        options[ksplit] = cps
    fill = min(SMS, tiles * max(options))

    def cost(ksplit):
        return tiles * ksplit < fill, _cdiv(tiles * ksplit, slots) * (options[ksplit] + FILL)

    ksplit = min(options, key=cost)
    return mt, ksplit, options[ksplit]


def _launch(x2: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor, out_dtype,
            batch_invariant: bool = False) -> torch.Tensor:
    m, k = x2.shape
    n = w_q.shape[1]
    if w_q.dtype != torch.int8:
        raise NotImplementedError(f"the CUDA W8A16 kernel takes int8 weights, got {w_q.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bfloat16 or float32, got {out_dtype}")
    if k % 8 or n % 16:
        raise ValueError(f"kernel needs K % 8 == 0 and N % 16 == 0, got K={k} N={n}")
    dev = x2.device
    if w_q.device != dev or scale.device != dev:
        raise ValueError("x, w_q and scale must lie on one device")
    xb = x2.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:
        xb = xb.clone()
    w = w_q.contiguous()
    s = scale.to(torch.float32).contiguous()
    if w.data_ptr() % 16:
        raise ValueError("w_q must be 16-byte aligned")
    mt, ksplit, cps = plan(m, k, n, batch_invariant)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    ws = torch.empty((ksplit, m, n), dtype=torch.float32, device=dev) if ksplit > 1 else None
    lib = _lib()
    err = lib.w8a16_matmul(
        xb.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None,
        m, k, n, mt, ksplit, cps, int(out_dtype == torch.float32),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "w8a16_matmul")
    int8_matmul.launches += 1
    return out


def _lib():
    lib = _build.load("int8_matmul")
    fn = lib.w8a16_matmul
    if not fn.argtypes:
        lib.w8a16_init.restype = ctypes.c_int
        _build.check(lib.w8a16_init(), "w8a16_init")  # shared-memory limits, once per load
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                batch_invariant: bool = False) -> torch.Tensor:
    """``x [..., K] @ dequant(w_q [K, N], scale [N]) -> [..., N]`` in x's
    dtype. CPU tensors take the plain version; CUDA tensors the kernel,
    planned with ``batch_invariant`` (see :func:`plan`)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu":
        out = int8_matmul_ref(x2, w_q, scale)
    elif x.device.type == "cuda":
        out = _launch(x2, w_q, scale, x.dtype, batch_invariant)
    else:
        raise ValueError(f"unsupported device {x.device}")
    return out.reshape(*lead, w_q.shape[1])


int8_matmul.launches = 0
