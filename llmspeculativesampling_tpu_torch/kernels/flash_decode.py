"""Length-aware flash-decode attention over the contiguous KV cache, dense
and int8 KV.

Counterpart of ``llmspeculativesampling_tpu/kernels/flash_decode.py``. The
TPU kernel it replaces is ``_flash_call`` (``pl.pallas_call`` with body
``_make_kernel(paged=False)``); on Hopper it is ``csrc/flash_decode.cu``,
whose header says what bounds it and what the design does about it. The
Mosaic workarounds of the TPU wrapper (lane folding for D < 128, the
1-column new-block pad, the q-row pad to 8, VMEM head grouping,
``custom_vmap``) have no Hopper counterpart and are not carried over.

:func:`flash_decode_attention` launches the CUDA kernel for CUDA tensors, or
raises; :func:`flash_decode_ref`, the plain PyTorch version, serves CPU
tensors and is the oracle. ``flash_decode_attention.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

_MASK = -1e30
MAX_S_NEW = 32
HEAD_DIMS = (32, 64, 96, 128)  # the kernel's instantiations (D/32 dims per lane)


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
    lib = _build.load("flash_decode")
    fn = lib.flash_decode
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 10 + [i] * 8 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


def _launch(q, k_new, v_new, k_cache, v_cache, lengths, block_bias, scale, k_scales, v_scales):
    bsz, hq, s_new, d = q.shape
    _, hkv, s_max, d2 = k_cache.shape
    quant = k_scales is not None
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bfloat16 or float32, got {q.dtype}")
    if d != d2 or d not in HEAD_DIMS:
        raise ValueError(f"head_dim must be one of {HEAD_DIMS} (q {d}, cache {d2})")
    if not 1 <= s_new <= MAX_S_NEW:
        raise ValueError(f"new block of {s_new} rows; the kernel takes 1..{MAX_S_NEW}")
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} kv heads")
    want_cache = torch.int8 if quant else q.dtype
    if k_cache.dtype != want_cache or v_cache.dtype != want_cache:
        raise TypeError(f"cache must be {want_cache}, got {k_cache.dtype}")
    dev = q.device
    q = q.contiguous()
    k_new = k_new.to(q.dtype).contiguous()
    v_new = v_new.to(q.dtype).contiguous()
    k_cache = k_cache.contiguous()
    v_cache = v_cache.contiguous()
    bias = block_bias.to(torch.float32).expand(bsz, s_new, s_new).contiguous()
    if quant:
        k_scales = k_scales.to(torch.float32).contiguous()
        v_scales = v_scales.to(torch.float32).contiguous()
    for t in (q, k_new, v_new, k_cache, v_cache):
        if t.device != dev or t.data_ptr() % 16:
            raise ValueError("tensors must lie on q's device, 16-byte aligned")
    out = torch.empty_like(q)
    err = _lib().flash_decode(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scales.data_ptr() if quant else None, v_scales.data_ptr() if quant else None,
        lengths.data_ptr(), bias.data_ptr(), out.data_ptr(),
        bsz, hkv, hq // hkv, s_new, s_max, d, int(q.dtype == torch.float32), int(quant),
        float(scale), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "flash_decode")
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
