"""Length-aware flash-decode attention over the contiguous KV cache, dense
and int8 KV.

Counterpart of ``llmspeculativesampling_tpu/kernels/flash_decode.py``. The
TPU kernel it replaces is ``_flash_call`` (``pl.pallas_call`` with body
``_make_kernel(paged=False)``); on Hopper it is ``csrc/flash_decode.cu``, a
split-KV kernel on the tensor cores that merges its splits in the same
launch, whose header says what bounds it and what the design does about it.
:func:`plan` picks the split size and the grid from the shapes the host
knows. The Mosaic workarounds of the TPU wrapper (lane folding for D < 128,
the 1-column new-block pad, the q-row pad to 8, VMEM head grouping,
``custom_vmap``) have no Hopper counterpart and are not carried over.

:func:`flash_decode_attention` launches the CUDA kernel for CUDA tensors, or
raises; :func:`flash_decode_ref`, the plain PyTorch version, serves CPU
tensors and is the oracle. :func:`partial_ref` and :func:`combine_ref` are
the split-and-merge arithmetic in plain PyTorch, for the tests.
``flash_decode_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional

import torch

from . import _build

_MASK = -1e30
MAX_S_NEW = 32
HEAD_DIMS = (32, 64, 96, 128)  # the kernel's instantiations
SMS = 132  # H100 SXM
SPLITS = (64, 128, 256, 512)  # prefix positions a split, smallest first
MAX_BLOCKS_PER_SM = 8
MAX_WARPS = 4  # 16-row warps in a row tile
_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class Plan(NamedTuple):
    """Grid of one call: ``ps`` prefix positions a split (a page holds
    ``ppp`` splits; ``n_split`` prefix splits in all, then the new block's),
    ``warps`` 16-row warps a row tile, ``tiles`` row tiles."""
    ps: int
    ppp: int
    n_split: int
    warps: int
    tiles: int

    def blocks(self, bsz: int, hkv: int) -> int:
        return bsz * hkv * self.tiles * (self.n_split + 1)

    def workspace(self, bsz: int, hkv: int, d: int) -> int:
        """fp32 words of partials: (acc[D], m, l) per split and row."""
        return self.blocks(bsz, hkv) * 16 * self.warps * (d + 2)


@functools.lru_cache(maxsize=None)
def plan(bsz: int, hkv: int, rows: int, page: int, pages: int = 1) -> Plan:
    """The grid for ``rows`` = G*S_new query rows per (batch row, kv head)
    over ``pages`` pages of ``page`` positions (the contiguous cache is one
    page of S_max). The smallest split of ``SPLITS`` whose grid holds at
    most ``MAX_BLOCKS_PER_SM`` blocks per SM, else the largest; a split never
    crosses a page. Every block, live or past the length, pays a fixed
    latency (lengths, q, the first copies, its ticket) and the merge reads
    each live split, so on the H100 fewer, longer splits won down to 64
    positions (``scripts/torch_flash_split_sweep.py``). Lengths stay on the
    device, so the grid covers every position a row can hold."""
    warps = min(MAX_WARPS, _cdiv(rows, 16))
    tiles = _cdiv(rows, 16 * warps)
    for ps in SPLITS:
        ps = min(ps, page)
        ppp = _cdiv(page, ps)
        p = Plan(ps, ppp, pages * ppp, warps, tiles)
        if p.blocks(bsz, hkv) <= MAX_BLOCKS_PER_SM * SMS:
            break
    return p


def split_ranges(p: Plan, page: int):
    """[start, end) of each prefix split in position order, before the
    length cuts it; the new block's split follows them."""
    out = []
    for j in range(p.n_split):
        pg, part = divmod(j, p.ppp)
        start = pg * page + part * p.ps
        out.append((start, min(start + p.ps, (pg + 1) * page)))
    return out


def partial_ref(qg, k, v, bias=None, k_scales=None, v_scales=None):
    """One split's partials in fp32, as the kernel writes them: qg
    [B, Hkv, R, D] (scale folded), k/v [B, Hkv, n, D], bias [B, R, n] or
    None, scales [B, Hkv, n] or None -> (m [B, Hkv, R], l, acc [.., D])."""
    s = torch.einsum("bhrd,bhtd->bhrt", qg.float(), k.float())
    if k_scales is not None:
        s = s * k_scales.float()[:, :, None, :]
    if bias is not None:
        s = s + bias[:, None].float()
    m = s.amax(-1).clamp_min(_MASK)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    if v_scales is not None:
        p = p * v_scales.float()[:, :, None, :]
    return m, l, torch.einsum("bhrt,bhtd->bhrd", p, v.float())


def combine_ref(parts):
    """Merge split partials ``[(m, l, acc), ...]`` in order into the
    normalised context, as the kernel's last split does."""
    big = torch.stack([m for m, _, _ in parts]).amax(0)
    num = sum(torch.exp(m - big)[..., None] * acc for m, _, acc in parts)
    den = sum(torch.exp(m - big) * l for m, l, _ in parts)
    return num / den.clamp_min(1e-30)[..., None]


def should_use(s_new: int, mode: str = "auto") -> bool:
    """The forward's gate: the kernel serves short new blocks (decode,
    verify, tree steps); longer blocks (prefill) take the einsum path.
    ``mode="off"`` forces the einsum path. The TPU gate's floors
    (``s_max >= 2*block_t``, ``head_dim >= 64``, a TPU backend) do not carry
    over: a head size the kernel lacks raises on the card."""
    return mode != "off" and s_new <= MAX_S_NEW


def _lengths(length, bsz: int, device) -> torch.Tensor:
    if isinstance(length, torch.Tensor):
        return length.to(device=device, dtype=torch.int32).reshape(-1).expand(bsz).contiguous()
    return torch.full((bsz,), int(length), dtype=torch.int32, device=device)


def flash_decode_ref(
    q, k_new, v_new, k_cache, v_cache, length, block_bias, *,
    scale: float, k_scales=None, v_scales=None,
):
    """Plain version with the kernel's masking semantics, all in fp32:
    prefix positions < length are visible, the new block under its bias."""
    bsz, hq, s_new, d = q.shape
    hkv = k_cache.shape[1]
    g = hq // hkv
    s_max = k_cache.shape[2]
    kc = k_cache.float()
    vc = v_cache.float()
    if k_scales is not None:
        kc = kc * k_scales.float()[..., None]
        vc = vc * v_scales.float()[..., None]
    qg = q.reshape(bsz, hkv, g, s_new, d).float() * scale
    s_pre = torch.einsum("bhgsd,bhtd->bhgst", qg, kc)
    lens = _lengths(length, bsz, q.device)
    col = torch.arange(s_max, device=q.device)
    live = col[None, :] < lens[:, None]  # [B, S_max]
    s_pre = torch.where(live[:, None, None, None, :], s_pre, torch.full_like(s_pre, _MASK))
    s_blk = torch.einsum("bhgsd,bhtd->bhgst", qg, k_new.float())
    s_blk = s_blk + block_bias[:, None, None].float()
    p = torch.softmax(torch.cat([s_pre, s_blk], dim=-1), dim=-1)
    v_all = torch.cat([vc, v_new.float()], dim=2)
    ctx = torch.einsum("bhgst,bhtd->bhgsd", p, v_all)
    return ctx.reshape(bsz, hq, s_new, d).to(q.dtype)


def _lib():
    """The library of ``csrc/flash_decode.cu``: ``flash_decode`` (B2) and
    ``paged_flash_decode`` (B3), which takes the block tables and two more
    ints (pages, pool blocks)."""
    lib = _build.load("flash_decode")
    if not lib.flash_decode.argtypes:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.flash_decode.argtypes = [p] * 13 + [i64, i64] + [i] * 10 + [ctypes.c_float, p]
        lib.paged_flash_decode.argtypes = [p] * 14 + [i64, i64] + [i] * 12 + [ctypes.c_float, p]
        lib.flash_decode.restype = lib.paged_flash_decode.restype = ctypes.c_int
    return lib


def _counters(dev, n: int) -> torch.Tensor:
    """The device's zeroed ticket counters, at least ``n``. The kernel leaves
    them at 0, so one buffer serves every call in stream order; it grows
    outside CUDA-graph capture only."""
    buf = _COUNTERS.get(dev)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("flash-decode counters must grow before CUDA-graph capture")
        buf = torch.zeros(max(n, 1 << 16), dtype=torch.int32, device=dev)
        _COUNTERS[dev] = buf
    return buf


def _rows(t: torch.Tensor, name: str):
    """The (b, h, s) element strides of a [B, H, S, D] tensor the kernel
    reads or writes through them: D contiguous, every row 16-byte aligned
    (strides are powers-of-two multiples, so their OR tests them all)."""
    sb, sh, ss, sd = t.stride()
    if sd != 1 or t.data_ptr() % 16 or (sb | sh | ss) * t.element_size() % 16:
        raise ValueError(f"{name}: the kernel needs D contiguous and 16-byte aligned rows")
    return sb, sh, ss


def launch_common(q, k_new, v_new, k_pre, v_pre, lengths, block_bias, scale, k_scales, v_scales,
                  page: int, pages: int, tables=None) -> torch.Tensor:
    """Checks shared by B2 and B3, then one launch. ``k_pre``/``v_pre``: the
    contiguous cache (``page`` = S_max, ``pages`` = 1, B2) or the pool
    (``tables`` [B, P], B3). Returns ctx [B, Hq, S_new, D] as a view of
    [B, S_new, Hq, D] memory, the layout the forward consumes."""
    bsz, hq, s_new, d = q.shape
    hkv = k_pre.shape[1]
    quant = k_scales is not None
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bfloat16 or float32, got {q.dtype}")
    if d != k_pre.shape[3] or d not in HEAD_DIMS:
        raise ValueError(f"head_dim must be one of {HEAD_DIMS} (q {d}, cache {k_pre.shape[3]})")
    if not 1 <= s_new <= MAX_S_NEW:
        raise ValueError(f"new block of {s_new} rows; the kernel takes 1..{MAX_S_NEW}")
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} kv heads")
    want = torch.int8 if quant else q.dtype
    if k_pre.dtype != want or v_pre.dtype != want:
        raise TypeError(f"cache must be {want}, got {k_pre.dtype}")
    dev = q.device
    k_new, v_new = k_new.to(q.dtype), v_new.to(q.dtype)
    in_strides = (*_rows(q, "q"), *_rows(k_new, "k_new"), *_rows(v_new, "v_new"))
    k_pre, v_pre = k_pre.contiguous(), v_pre.contiguous()
    bias = block_bias.to(torch.float32).expand(bsz, s_new, s_new).contiguous()
    if quant:
        k_scales = k_scales.to(torch.float32).contiguous()
        v_scales = v_scales.to(torch.float32).contiguous()
    if any(t.get_device() != q.get_device() for t in (k_new, v_new, k_pre, v_pre, lengths, bias)):
        raise ValueError("tensors must lie on q's device")
    if k_pre.data_ptr() % 16 or v_pre.data_ptr() % 16:
        raise ValueError("cache must be 16-byte aligned")
    pl = plan(bsz, hkv, s_new * (hq // hkv), page, pages)
    out = torch.empty((bsz, s_new, hq, d), dtype=q.dtype, device=dev).transpose(1, 2)
    ws = torch.empty(pl.workspace(bsz, hkv, d), dtype=torch.float32, device=dev)
    n_tiles = bsz * hkv * pl.tiles
    counters = _counters(dev, n_tiles)
    strides = (ctypes.c_longlong * 12)(*in_strides, *_rows(out, "out"))
    head = [q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_pre.data_ptr(), v_pre.data_ptr(),
            k_scales.data_ptr() if quant else None, v_scales.data_ptr() if quant else None,
            lengths.data_ptr()]
    if tables is not None:
        head.append(tables.data_ptr())
    geometry = [bsz, hkv, hq // hkv, s_new]
    geometry += [page] if tables is None else [pages, page, k_pre.shape[0]]
    name = "flash_decode" if tables is None else "paged_flash_decode"
    err = getattr(_lib(), name)(
        *head, bias.data_ptr(), out.data_ptr(), ws.data_ptr(), counters.data_ptr(), strides,
        ws.numel(), counters.numel(), *geometry, d, int(q.dtype == torch.float32), int(quant),
        pl.ps, pl.warps, float(scale), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, name)
    return out


def _launch(q, k_new, v_new, k_cache, v_cache, lengths, block_bias, scale, k_scales, v_scales):
    out = launch_common(q, k_new, v_new, k_cache, v_cache, lengths, block_bias,
                        scale, k_scales, v_scales, page=k_cache.shape[2], pages=1)
    flash_decode_attention.launches += 1
    return out


def flash_decode_attention(
    q: torch.Tensor,        # [B, Hq, S_new, D]
    k_new: torch.Tensor,    # [B, Hkv, S_new, D]
    v_new: torch.Tensor,
    k_cache: torch.Tensor,  # [B, Hkv, S_max, D]; positions >= length ignored
    v_cache: torch.Tensor,
    length,                 # int, or int32 tensor [] / [B]
    block_bias: torch.Tensor,  # [B, S_new, S_new] f32 additive (0 / -1e30)
    *,
    scale: float,
    k_scales: Optional[torch.Tensor] = None,  # [B, Hkv, S_max] f32 (int8 cache)
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Context [B, Hq, S_new, D] in q's dtype. CPU tensors take the plain
    version; CUDA tensors the kernel."""
    if q.device.type == "cpu":
        return flash_decode_ref(
            q, k_new, v_new, k_cache, v_cache, length, block_bias,
            scale=scale, k_scales=k_scales, v_scales=v_scales,
        )
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    lengths = _lengths(length, q.shape[0], q.device)
    return _launch(q, k_new, v_new, k_cache, v_cache, lengths, block_bias, scale, k_scales, v_scales)


flash_decode_attention.launches = 0
