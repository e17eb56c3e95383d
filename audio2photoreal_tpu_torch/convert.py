"""JAX param tree -> this package's state_dict.

The inverse of ``audio2photoreal_tpu/train/convert.py:convert_film_denoiser``
(with ``convert_wav2vec_extractor`` for the bundled frontend): the port's
modules keep the torch reference's state-dict names, so the same mapping
read backwards carries weights trained by the JAX package into the port.

- Dense kernel [in, out] -> Linear weight [out, in]
- q/k/v Dense kernels -> packed ``in_proj_weight`` [3D, D] / ``in_proj_bias``
- conv kernel [K, Cin, Cout] -> Conv1d weight [Cout, Cin, K]
- LayerNorm / group norm scale, bias -> weight, bias
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _a(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _linear(sd: StateDict, prefix: str, p: Mapping[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _a(np.asarray(p["kernel"]).T)
    sd[f"{prefix}.bias"] = _a(p["bias"])


def _norm(sd: StateDict, prefix: str, p: Mapping[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _a(p["scale"])
    sd[f"{prefix}.bias"] = _a(p["bias"])


def _conv(sd: StateDict, prefix: str, kernel, bias=None) -> None:
    sd[f"{prefix}.weight"] = _a(np.asarray(kernel).transpose(2, 1, 0))
    if bias is not None:
        sd[f"{prefix}.bias"] = _a(bias)


def _mha(sd: StateDict, prefix: str, p: Mapping[str, Any]) -> None:
    names = ("q_proj", "k_proj", "v_proj")
    sd[f"{prefix}.in_proj_weight"] = _a(np.concatenate([np.asarray(p[n]["kernel"]).T for n in names]))
    sd[f"{prefix}.in_proj_bias"] = _a(np.concatenate([np.asarray(p[n]["bias"]) for n in names]))
    _linear(sd, f"{prefix}.out_proj", p["out_proj"])


def _decoder_layer(sd: StateDict, prefix: str, p: Mapping[str, Any]) -> None:
    _mha(sd, f"{prefix}.self_attn", p["self_attn"])
    _mha(sd, f"{prefix}.multihead_attn", p["cross_attn"])
    for n in ("norm1", "norm2", "norm3"):
        _norm(sd, f"{prefix}.{n}", p[n])
    for n in ("film1", "film2", "film3"):
        _linear(sd, f"{prefix}.{n}.block.1", p[n]["proj"])
    _linear(sd, f"{prefix}.linear1", p["ff"]["linear1"])
    _linear(sd, f"{prefix}.linear2", p["ff"]["linear2"])
    if "cross_attn2" in p:
        _mha(sd, f"{prefix}.multihead_attn2", p["cross_attn2"])
        _norm(sd, f"{prefix}.norm2a", p["norm2a"])
        _linear(sd, f"{prefix}.film2a.block.1", p["film2a"]["proj"])


def wav2vec_extractor_state_dict_from_jax(p: Mapping[str, Any], prefix: str) -> StateDict:
    """ConvFeatureExtractor params -> fairseq ``conv_layers.{i}.{0,2}`` names."""
    sd: StateDict = {}
    i = 0
    while f"conv{i}_kernel" in p:
        _conv(sd, f"{prefix}.conv_layers.{i}.0", p[f"conv{i}_kernel"])
        _norm(sd, f"{prefix}.conv_layers.{i}.2", p[f"norm{i}"])
        i += 1
    return sd


def film_denoiser_state_dict_from_jax(
    params: Mapping[str, Any], data_format: str, num_layers: int
) -> StateDict:
    """FiLMDenoiser params (``{"params": ...}`` or the inner tree) -> state_dict."""
    if data_format != "pose":
        raise NotImplementedError("face branch: see ROADMAP")
    p = params["params"] if "params" in params else params
    sd: StateDict = {}
    _linear(sd, "input_projection", p["input_projection"])
    _linear(sd, "cond_projection", p["cond_projection"])
    _norm(sd, "norm_cond", p["norm_cond"])
    _linear(sd, "time_mlp.1", p["time_dense"])
    _linear(sd, "to_time_cond.0", p["to_time_cond"])
    _linear(sd, "to_time_tokens.0", p["to_time_tokens"])
    _norm(sd, "non_attn_cond_projection.0", p["non_attn_norm"])
    _linear(sd, "non_attn_cond_projection.1", p["non_attn_d1"])
    _linear(sd, "non_attn_cond_projection.3", p["non_attn_d2"])
    for n in ("null_cond_embed", "null_cond_hidden", "null_pose_embed"):
        sd[n] = _a(p[n])
    for i in range(num_layers):
        _decoder_layer(sd, f"seqTransDecoder.stack.{i}", p[f"decoder_{i}"])
    _linear(sd, "final_layer", p["final_layer"])
    _linear(sd, "frame_cond_projection", p["frame_cond_projection"])
    _norm(sd, "frame_norm_cond", p["frame_norm_cond"])
    for i in range(6):
        _conv(sd, f"post_pose_layers.{i}", p[f"post_conv{i}_kernel"], p[f"post_conv{i}_bias"])
    _conv(sd, "final_conv", p["final_conv_kernel"], p["final_conv_bias"])
    if "audio_frontend" in p:
        sd.update(wav2vec_extractor_state_dict_from_jax(
            p["audio_frontend"]["feature_extractor"], "audio_model.feature_extractor"
        ))
    return sd
