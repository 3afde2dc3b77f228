"""Local HF checkpoints -> the port's param trees (counterpart of
``llmspeculativesampling_tpu/core/loader.py``).

Reads a local directory (``config.json`` and ``*.safetensors``) or an
in-memory state dict, transposes Linear weights from ``[out, in]`` to
``[in, out]`` and stacks per-layer tensors on a leading ``L`` axis. Local
files only: nothing is downloaded. The safetensors format is read by this
module (:func:`read_safetensors`), so no ``safetensors`` package is needed.

:func:`save_params` / :func:`load_params` keep a converted or quantized
tree (int8 and fp8 leaves included) as one ``torch.save`` file beside a
``meta.json`` of family and config, where the JAX package uses orbax;
``load_pretrained(cache_dir=...)`` converts once and restores after.
"""

from __future__ import annotations

import dataclasses
import json
import math
import mmap
import os
import struct
from typing import Dict, Mapping

import torch

from .config import LlamaConfig, OPTConfig, resolve_device

# safetensors dtype names -> torch dtypes
_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool, "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
}
_PARAMS_FILE = "params.pt"


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """One ``.safetensors`` file -> {name: CPU tensor}. The format: an
    8-byte little-endian header length N, N bytes of JSON mapping each
    name to its dtype, shape and ``data_offsets`` [begin, end) into the
    bytes that follow (``__metadata__`` aside). Tensors are copied out of a
    private mapping of the file, which is closed on return."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        size = os.fstat(f.fileno()).st_size
        out = {}
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) as mm:
            for name, info in header.items():
                if name == "__metadata__":
                    continue
                dtype = _ST_DTYPES.get(info["dtype"])
                if dtype is None:
                    raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
                begin, end = info["data_offsets"]
                shape = info["shape"]
                count = math.prod(shape)
                if end - begin != count * dtype.itemsize or 8 + n + end > size:
                    raise ValueError(f"{path}: tensor {name!r} has inconsistent offsets")
                if count == 0:
                    out[name] = torch.empty(shape, dtype=dtype)
                    continue
                t = torch.frombuffer(mm, dtype=dtype, count=count, offset=8 + n + begin)
                out[name] = t.reshape(shape).clone()
                del t  # release the export before the mapping closes
    return out


def read_safetensors_dir(path: str) -> Dict[str, torch.Tensor]:
    """Every ``*.safetensors`` file of a directory, merged."""
    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    sd: Dict[str, torch.Tensor] = {}
    for fname in files:
        sd.update(read_safetensors(os.path.join(path, fname)))
    return sd


def parse_rope_scaling(rs) -> tuple | None:
    """HF ``rope_scaling`` dict -> ("linear"|"dynamic", factor), the two
    rotary variants the decoder implements; any other type (yarn, llama3,
    longrope, ...) raises rather than load wrong rotary embeddings."""
    if rs is None:
        return None
    kind = rs.get("rope_type", rs.get("type"))
    if kind in (None, "default"):
        return None
    if kind not in ("linear", "dynamic"):
        raise ValueError(
            f"unsupported rope_scaling type {kind!r}: only 'linear' and 'dynamic' (NTK) are "
            "implemented; refusing to load the checkpoint with wrong rotary embeddings")
    return (kind, float(rs["factor"]))


def llama_config_from_hf(hf: Mapping) -> LlamaConfig:
    return LlamaConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        max_position=hf.get("max_position_embeddings", 4096),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        rope_theta=hf.get("rope_theta", 10000.0),
        rope_scaling=parse_rope_scaling(hf.get("rope_scaling")),
        tie_embeddings=hf.get("tie_word_embeddings", False),
    )


def opt_config_from_hf(hf: Mapping) -> OPTConfig:
    proj = hf.get("word_embed_proj_dim")
    return OPTConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        ffn_dim=hf["ffn_dim"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        max_position=hf.get("max_position_embeddings", 2048),
        word_embed_proj_dim=None if proj in (None, hf["hidden_size"]) else proj,
        do_layer_norm_before=hf.get("do_layer_norm_before", True),
    )


def _mapper(sd: Mapping, n_layers: int, dtype: torch.dtype, device):
    """(get, stack): one tensor of ``sd``, or the per-layer tensors of a
    name pattern stacked on a leading L axis, transposed to [in, out] for
    Linear weights, in ``dtype`` on ``device``. Each layer's tensor is cast
    before the stack, so no fp32 copy of the stack is made."""
    def get(name, transpose=False):
        t = torch.as_tensor(sd[name])
        return (t.t() if transpose else t).to(dtype).contiguous().to(device)

    def stack(fmt, transpose=False):
        return torch.stack([get(fmt.format(i), transpose) for i in range(n_layers)])

    return get, stack


def llama_params_from_state_dict(sd: Mapping, cfg: LlamaConfig, dtype=None, device=None) -> Dict:
    """HF Llama / Qwen2 (qkv biases, ``cfg.qkv_bias``) / Mistral names ->
    the Llama tree."""
    get, stack = _mapper(sd, cfg.num_layers, dtype or cfg.torch_dtype, resolve_device(device))
    layers = {
        "wq": stack("model.layers.{}.self_attn.q_proj.weight", True),
        "wk": stack("model.layers.{}.self_attn.k_proj.weight", True),
        "wv": stack("model.layers.{}.self_attn.v_proj.weight", True),
        "wo": stack("model.layers.{}.self_attn.o_proj.weight", True),
        "w_gate": stack("model.layers.{}.mlp.gate_proj.weight", True),
        "w_up": stack("model.layers.{}.mlp.up_proj.weight", True),
        "w_down": stack("model.layers.{}.mlp.down_proj.weight", True),
        "ln_attn": stack("model.layers.{}.input_layernorm.weight"),
        "ln_mlp": stack("model.layers.{}.post_attention_layernorm.weight"),
    }
    if cfg.qkv_bias:
        for key, proj in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj")):
            layers[key] = stack("model.layers.{}.self_attn." + proj + ".bias")
    params = {"embed": get("model.embed_tokens.weight"), "layers": layers,
              "ln_final": get("model.norm.weight")}
    if not cfg.tie_embeddings:
        params["lm_head"] = get("lm_head.weight")
    return params


def opt_params_from_state_dict(sd: Mapping, cfg: OPTConfig, dtype=None, device=None) -> Dict:
    """HF OPT names -> the OPT tree (see ``models/opt.py``): the final
    LayerNorm, the 350m projections and an untied ``lm_head`` where the
    checkpoint has them."""
    pre = "model.decoder."
    get, stack = _mapper(sd, cfg.num_layers, dtype or cfg.torch_dtype, resolve_device(device))
    layers = {}
    for key, name, transpose in (
            ("wq", "self_attn.q_proj.weight", True), ("bq", "self_attn.q_proj.bias", False),
            ("wk", "self_attn.k_proj.weight", True), ("bk", "self_attn.k_proj.bias", False),
            ("wv", "self_attn.v_proj.weight", True), ("bv", "self_attn.v_proj.bias", False),
            ("wo", "self_attn.out_proj.weight", True), ("bo", "self_attn.out_proj.bias", False),
            ("ln_attn_w", "self_attn_layer_norm.weight", False),
            ("ln_attn_b", "self_attn_layer_norm.bias", False),
            ("fc1_w", "fc1.weight", True), ("fc1_b", "fc1.bias", False),
            ("fc2_w", "fc2.weight", True), ("fc2_b", "fc2.bias", False),
            ("ln_mlp_w", "final_layer_norm.weight", False),
            ("ln_mlp_b", "final_layer_norm.bias", False)):
        layers[key] = stack(pre + "layers.{}." + name, transpose)
    params = {"embed": get(pre + "embed_tokens.weight"),
              "embed_pos": get(pre + "embed_positions.weight"), "layers": layers}
    if pre + "final_layer_norm.weight" in sd:
        params["ln_final_w"] = get(pre + "final_layer_norm.weight")
        params["ln_final_b"] = get(pre + "final_layer_norm.bias")
    if pre + "project_in.weight" in sd:
        params["project_in"] = get(pre + "project_in.weight", True)
        params["project_out"] = get(pre + "project_out.weight", True)
    if "lm_head.weight" in sd:  # OPT ties the head to embed_tokens unless the checkpoint has one
        params["lm_head"] = get("lm_head.weight")
    return params


def load_pretrained(path: str, dtype: str = "bfloat16", cache_dir: str = None, device=None):
    """A local HF checkpoint directory -> (family, cfg, params) on
    ``device`` (default the card), chosen by ``config.json``'s model_type:
    llama, qwen2 and mistral map onto the Llama decoder, opt onto OPT.

    Qwen2 (its qkv biases) and Mistral run full attention, which equals
    their sliding-window attention while the context stays within the
    window: where a window applies, ``max_position`` is clamped to it and
    the config records it, so ``ModelBundle.make_cache`` rejects a larger
    cache. ``cache_dir``: the first load converts and saves there
    (:func:`save_params`); later loads restore from it."""
    if cache_dir and os.path.exists(os.path.join(cache_dir, "meta.json")):
        return load_params(cache_dir, device=device)
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    sd = read_safetensors_dir(path)
    model_type = hf.get("model_type", "")
    if model_type in ("llama", "qwen2", "mistral"):
        cfg = llama_config_from_hf(hf)
        window = None
        if model_type == "mistral" or (model_type == "qwen2" and hf.get("use_sliding_window")):
            window = hf.get("sliding_window")
        max_pos = min(cfg.max_position, window) if window is not None else cfg.max_position
        cfg = dataclasses.replace(cfg, dtype=dtype, max_position=max_pos,
                                  qkv_bias=model_type == "qwen2", sliding_window=window)
        out = "llama", cfg, llama_params_from_state_dict(sd, cfg, device=device)
    elif model_type == "opt":
        cfg = dataclasses.replace(opt_config_from_hf(hf), dtype=dtype)
        out = "opt", cfg, opt_params_from_state_dict(sd, cfg, device=device)
    else:
        raise ValueError(f"unsupported model_type {model_type!r} at {path}")
    if cache_dir:
        save_params(cache_dir, *out)
    return out


def save_params(ckpt_dir: str, family: str, cfg, params) -> None:
    """Write (family, cfg, params) to ``ckpt_dir``: the tree as it is (int8
    and fp8 leaves keep their dtypes) in one file, the config in
    ``meta.json``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    torch.save(params, os.path.join(ckpt_dir, _PARAMS_FILE))
    with open(os.path.join(ckpt_dir, "meta.json"), "w") as f:
        json.dump({"family": family, "cfg": dataclasses.asdict(cfg)}, f)


def load_params(ckpt_dir: str, device=None):
    """Restore (family, cfg, params) written by :func:`save_params`, the
    params on ``device`` (default the card)."""
    dev = resolve_device(device)
    with open(os.path.join(ckpt_dir, "meta.json")) as f:
        meta = json.load(f)
    family = meta["family"]
    fields = dict(meta["cfg"])
    if fields.get("rope_scaling") is not None:  # JSON gives back a list
        fields["rope_scaling"] = tuple(fields["rope_scaling"])
    cfg = {"llama": LlamaConfig, "opt": OPTConfig}[family](**fields)
    params = torch.load(os.path.join(ckpt_dir, _PARAMS_FILE), map_location=dev, weights_only=True)
    return family, cfg, params
