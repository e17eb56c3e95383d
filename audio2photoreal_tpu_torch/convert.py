"""JAX param tree -> this package's state_dict.

The inverse of ``audio2photoreal_tpu/train/convert.py:convert_film_denoiser``
(with ``convert_wav2vec_extractor`` for the bundled frontend and, for a face
model, ``convert_lip_regressor`` and ``encoder_layer_rotary``), of
``convert_guide`` and ``convert_vqvae`` (the guide LM and the residual VQ
with its codebook state) and of ``convert_body_avatar`` (the ca_body render
avatar), and, for the modules the JAX converter does not cover
(``AudioTcn``, ``Wav2VecDownsampler``, the ELR layers), the same layout
rules applied to their JAX trees: the port's
modules keep the torch reference's state-dict names, so the same mapping
read backwards carries weights trained by the JAX package into the port.

- Dense kernel [in, out] -> Linear weight [out, in]
- q/k/v Dense kernels -> packed ``in_proj_weight`` [3D, D] / ``in_proj_bias``
- conv kernel [K, Cin, Cout] -> Conv1d weight [Cout, Cin, K]
- LayerNorm / group norm scale, bias -> weight, bias
- weight-norm {v, g, bias} -> ``weight_v`` / ``weight_g`` / ``bias``, conv
  kernels [kh, kw, Cin, Cout] -> [Cout, Cin, kh, kw], untied biases
  [H, W, C] -> [C, H, W]
- ELR weights: Linear [in, out] -> [out, in]; conv [kh, kw, Cin/g, Cout]
  -> [Cout, Cin/g, kh, kw] and transposed conv [kh, kw, Cout/g, Cin] ->
  [Cin, Cout/g, kh, kw], one permutation for both
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


def wav2vec_aggregator_state_dict_from_jax(p: Mapping[str, Any], prefix: str) -> StateDict:
    """ConvAggregator params -> fairseq ``conv_layers.{i}.{1,3}`` names (the
    conv after the pad, the norm after the dropout)."""
    sd: StateDict = {}
    i = 0
    while f"conv{i}_kernel" in p:
        _conv(sd, f"{prefix}.conv_layers.{i}.1", p[f"conv{i}_kernel"], p[f"conv{i}_bias"])
        _norm(sd, f"{prefix}.conv_layers.{i}.3", p[f"norm{i}"])
        i += 1
    return sd


def wav2vec_downsampler_state_dict_from_jax(params: Mapping[str, Any]) -> StateDict:
    """Wav2VecDownsampler params -> ``conv1``, ``conv2``, ``norm``."""
    p = params["params"] if "params" in params else params
    sd: StateDict = {}
    for n in ("conv1", "conv2"):
        _conv(sd, n, p[f"{n}_kernel"], p[f"{n}_bias"])
    _norm(sd, "norm", p["norm"])
    return sd


def audio_tcn_state_dict_from_jax(params: Mapping[str, Any]) -> StateDict:
    """AudioTcn params -> the frozen ``wav2vec_extractor`` /
    ``wav2vec_aggregator`` (fairseq names), ``w2v_post``, ``tcn.{i}`` and
    ``final``."""
    p = params["params"] if "params" in params else params
    sd: StateDict = {}
    if "wav2vec_extractor" in p:
        sd.update(wav2vec_extractor_state_dict_from_jax(p["wav2vec_extractor"], "wav2vec_extractor"))
        sd.update(wav2vec_aggregator_state_dict_from_jax(p["wav2vec_aggregator"], "wav2vec_aggregator"))
        _conv(sd, "w2v_post", p["w2v_post_kernel"], p["w2v_post_bias"])
    i = 0
    while f"tcn{i}_kernel" in p:
        _conv(sd, f"tcn.{i}", p[f"tcn{i}_kernel"], p[f"tcn{i}_bias"])
        i += 1
    _conv(sd, "final", p["final_kernel"], p["final_bias"])
    return sd


def linear_elr_state_dict_from_jax(params: Mapping[str, Any]) -> StateDict:
    """LinearELR params -> ``weight`` [out, in] (and ``bias``)."""
    p = params["params"] if "params" in params else params
    sd: StateDict = {"weight": _a(np.asarray(p["weight"]).T)}
    if "bias" in p:
        sd["bias"] = _a(p["bias"])
    return sd


def conv2d_elr_state_dict_from_jax(params: Mapping[str, Any]) -> StateDict:
    """Conv2dELR params, plain or transposed -> ``weight`` in the torch
    layout (and ``bias``, an untied one [H, W, C] as [C, H, W])."""
    p = params["params"] if "params" in params else params
    sd: StateDict = {"weight": _a(np.asarray(p["weight"]).transpose(3, 2, 0, 1))}
    if "bias" in p:
        b = np.asarray(p["bias"])
        sd["bias"] = _a(b.transpose(2, 0, 1) if b.ndim == 3 else b)
    return sd


def rotary_encoder_layer_state_dict(sd: StateDict, prefix: str, p: Mapping[str, Any]) -> None:
    """RotaryEncoderLayer params -> ``self_attn``, ``norm{1,2}``,
    ``linear{1,2}`` (what ``encoder_layer_rotary`` reads)."""
    _mha(sd, f"{prefix}.self_attn", p["self_attn"])
    _norm(sd, f"{prefix}.norm1", p["norm1"])
    _norm(sd, f"{prefix}.norm2", p["norm2"])
    _linear(sd, f"{prefix}.linear1", p["ff"]["linear1"])
    _linear(sd, f"{prefix}.linear2", p["ff"]["linear2"])


def _plain_layer(sd: StateDict, prefix: str, p: Mapping[str, Any]) -> None:
    """The lip regressor's _EncLayer / _DecLayer -> the reference's
    TransformerEncoderLayer / TransformerDecoderLayer names."""
    for n in ("norm1", "norm2", "norm3"):
        if n in p:
            _norm(sd, f"{prefix}.{n}", p[n])
    for n in ("self_attn", "cross_attn"):
        if n in p:
            _mha(sd, f"{prefix}.{n}.{n}", p[n])
    _linear(sd, f"{prefix}.feedforward.ff.0", p["ff"]["linear1"])
    _linear(sd, f"{prefix}.feedforward.ff.3", p["ff"]["linear2"])


def lip_regressor_state_dict_from_jax(p: Mapping[str, Any], prefix: str = "") -> StateDict:
    """LipRegressor params -> the names ``convert_lip_regressor`` reads."""
    sd: StateDict = {}
    enc = p["audio_encoder"]
    w2v = f"{prefix}audio_encoder.wav2vec_model"
    sd.update(wav2vec_extractor_state_dict_from_jax(enc["feature_extractor"], f"{w2v}.feature_extractor"))
    sd.update(wav2vec_aggregator_state_dict_from_jax(enc["feature_aggregator"], f"{w2v}.feature_aggregator"))
    i = 0
    while f"enc_{i}" in p:
        _plain_layer(sd, f"{prefix}regression_model.transformer_encoder.{i}", p[f"enc_{i}"])
        i += 1
    i = 0
    while f"dec_{i}" in p:
        _plain_layer(sd, f"{prefix}regression_model.transformer_decoder.{i}", p[f"dec_{i}"])
        i += 1
    _linear(sd, f"{prefix}project_output", p["project_output"])
    return sd


def film_denoiser_state_dict_from_jax(
    params: Mapping[str, Any], data_format: str, num_layers: int
) -> StateDict:
    """FiLMDenoiser params (``{"params": ...}`` or the inner tree) -> state_dict."""
    if data_format not in ("pose", "face"):
        raise ValueError(f"data_format must be pose or face; got {data_format!r}")
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
    for n in ("null_cond_embed", "null_cond_hidden"):
        sd[n] = _a(p[n])
    for i in range(num_layers):
        _decoder_layer(sd, f"seqTransDecoder.stack.{i}", p[f"decoder_{i}"])
    _linear(sd, "final_layer", p["final_layer"])
    if data_format == "pose":
        sd["null_pose_embed"] = _a(p["null_pose_embed"])
        _linear(sd, "frame_cond_projection", p["frame_cond_projection"])
        _norm(sd, "frame_norm_cond", p["frame_norm_cond"])
        for i in range(6):
            _conv(sd, f"post_pose_layers.{i}", p[f"post_conv{i}_kernel"], p[f"post_conv{i}_bias"])
        _conv(sd, "final_conv", p["final_conv_kernel"], p["final_conv_bias"])
    else:
        i = 0
        while f"cond_encoder_{i}" in p:
            rotary_encoder_layer_state_dict(sd, f"cond_encoder.{i}", p[f"cond_encoder_{i}"])
            i += 1
        sd.update(lip_regressor_state_dict_from_jax(p["lip_model"], "lip_model."))
    if "audio_frontend" in p:
        sd.update(wav2vec_extractor_state_dict_from_jax(
            p["audio_frontend"]["feature_extractor"], "audio_model.feature_extractor"
        ))
    return sd


def guide_state_dict_from_jax(params: Mapping[str, Any]) -> StateDict:
    """GuideTransformer params (``{"params": ...}`` or the inner tree) ->
    state_dict under the names ``convert_guide`` reads: the pre-net's convs
    at ``pre_audio.{3i}`` (conv, leaky ReLU, dropout) and its 1x1 conv after
    them, the wav2vec frontend under ``audio_model.feature_extractor``."""
    p = params["params"] if "params" in params else params
    sd: StateDict = {"token_embedding.weight": _a(p["token_embedding"]["embedding"])}
    _linear(sd, "cond_projection", p["cond_projection"])
    _norm(sd, "norm_cond", p["norm_cond"])
    _norm(sd, "non_attn_cond_projection.0", p["non_attn_norm"])
    _linear(sd, "non_attn_cond_projection.1", p["non_attn_d1"])
    _linear(sd, "non_attn_cond_projection.3", p["non_attn_d2"])
    for n in ("null_cond_embed", "null_cond_hidden"):
        sd[n] = _a(p[n])
    pre = p["pre_audio"]
    i = 0
    while f"conv{i}_kernel" in pre:
        _conv(sd, f"pre_audio.{3 * i}", pre[f"conv{i}_kernel"], pre[f"conv{i}_bias"])
        i += 1
    _conv(sd, f"pre_audio.{3 * i}", pre["conv_out_kernel"], pre["conv_out_bias"])
    i = 0
    while f"decoder_{i}" in p:
        _decoder_layer(sd, f"seqTransDecoder.stack.{i}", p[f"decoder_{i}"])
        i += 1
    _linear(sd, "final_layer", p["final_layer"])
    if "audio_frontend" in p:
        sd.update(wav2vec_extractor_state_dict_from_jax(
            p["audio_frontend"]["feature_extractor"], "audio_model.feature_extractor"
        ))
    return sd


def vqvae_state_dict_from_jax(params: Mapping[str, Any], vq) -> StateDict:
    """TemporalVertexCodec params and a ``VQState`` (or a mapping with its
    ``embed``, ``embed_avg``, ``cluster_size``) -> state_dict under the
    names ``convert_vqvae`` reads: convs at ``encoder.enc.{2i}`` /
    ``decoder.dec.{2i}``, codebooks at ``quantizer.layers.{d}._codebook``,
    each with the state's ``inited`` flag when it has one (without, the
    codebooks load as inited)."""
    p = params["params"] if "params" in params else params
    vq = vq._asdict() if hasattr(vq, "_asdict") else vq
    sd: StateDict = {}
    for side, seq in (("encoder", "enc"), ("decoder", "dec")):
        i = 0
        while f"conv{i}_kernel" in p[side]:
            _conv(sd, f"{side}.{seq}.{2 * i}", p[side][f"conv{i}_kernel"], p[side][f"conv{i}_bias"])
            i += 1
    for name in ("embed", "embed_avg", "cluster_size"):
        for d, book in enumerate(np.asarray(vq[name])):
            sd[f"quantizer.layers.{d}._codebook.{name}"] = _a(book)
    if "inited" in vq:
        for d in range(len(np.asarray(vq["embed"]))):
            sd[f"quantizer.layers.{d}._codebook.inited"] = _a([float(bool(np.asarray(vq["inited"])))])
    return sd


# --------------------------------------------------------------------- #
# ca_body codec avatar (BodyAvatar)
# --------------------------------------------------------------------- #


def _chw_to_hwc_perm(c: int, h: int, w: int) -> np.ndarray:
    """perm[i_hwc] = i_chw: the JAX package's NHWC flat index → torch's."""
    return np.arange(c * h * w).reshape(c, h, w).transpose(1, 2, 0).reshape(-1)


def _wn_linear(sd: StateDict, prefix: str, p: Mapping[str, Any], chw_out=None, chw_in=None) -> None:
    """{v [in, out], g, bias} → LinearWN weight_v [out, in], weight_g [out, 1].

    ``chw_out``: the output is reshaped to a [C, H, W] block (torch c-major,
    JAX hwc-major); ``chw_in``: the first C·H·W inputs are a flattened
    [C, H, W] map.  Inverse of ``wn_linear_spatial_out`` / ``_in``."""
    v, g, b = (np.asarray(p[k], np.float32) for k in ("v", "g", "bias"))
    if chw_out is not None:
        perm = _chw_to_hwc_perm(*chw_out)
        v2, g2, b2 = np.empty_like(v), np.empty_like(g), np.empty_like(b)
        v2[:, perm], g2[perm], b2[perm] = v, g, b
        v, g, b = v2, g2, b2
    if chw_in is not None:
        perm = _chw_to_hwc_perm(*chw_in)
        v2 = v.copy()
        v2[perm] = v[: perm.size]
        v = v2
    sd[f"{prefix}.weight_v"] = _a(v.T)
    sd[f"{prefix}.weight_g"] = _a(g.reshape(-1, 1))
    sd[f"{prefix}.bias"] = _a(b)


def _wn_conv(sd: StateDict, prefix: str, p: Mapping[str, Any]) -> None:
    """{v [kh, kw, Cin/g, Cout], g, bias} → weight_v [Cout, Cin/g, kh, kw];
    an untied bias [H, W, C] → [C, H, W]."""
    sd[f"{prefix}.weight_v"] = _a(np.asarray(p["v"]).transpose(3, 2, 0, 1))
    sd[f"{prefix}.weight_g"] = _a(np.asarray(p["g"]).reshape(-1, 1, 1, 1))
    b = np.asarray(p["bias"])
    sd[f"{prefix}.bias"] = _a(b.transpose(2, 0, 1) if b.ndim == 3 else b)


def _wn_convt(sd: StateDict, prefix: str, p: Mapping[str, Any]) -> None:
    """{v [kh, kw, Cout, Cin], g, bias [H, W, Cout]} → weight_v [Cin, Cout,
    kh, kw], weight_g [1, Cout, 1, 1], bias [Cout, H, W]."""
    sd[f"{prefix}.weight_v"] = _a(np.asarray(p["v"]).transpose(3, 2, 0, 1))
    sd[f"{prefix}.weight_g"] = _a(np.asarray(p["g"]).reshape(1, -1, 1, 1))
    sd[f"{prefix}.bias"] = _a(np.asarray(p["bias"]).transpose(2, 0, 1))


def _conv_block(sd: StateDict, prefix: str, p: Mapping[str, Any]) -> None:
    for n in ("conv_resize", "conv1", "conv2"):
        _wn_conv(sd, f"{prefix}.{n}", p[n])


def unet_wb_state_dict(sd: StateDict, prefix: str, p: Mapping[str, Any]) -> None:
    """UNetWB / UNetWBConcat (transpose-conv ups, untied biases) or UNetW
    (conv ups, tied biases): ``down{i}.0`` / ``up{i}.0`` / ``out``
    (ca_body/nn/unet.py)."""
    for i in range(1, 6):
        _wn_conv(sd, f"{prefix}.down{i}.0", p[f"down{i}"])
        up = p[f"up{i}"]
        (_wn_convt if np.asarray(up["bias"]).ndim == 3 else _wn_conv)(sd, f"{prefix}.up{i}.0", up)
    _wn_conv(sd, f"{prefix}.out", p["out"])


def shadow_unet_state_dict(sd: StateDict, prefix: str, p: Mapping[str, Any]) -> None:
    """ShadowUNet: ``enc_layers.{i}.0`` / ``dec_layers.{i}.0`` / ``shadow_pred``;
    also DistMapShadowUNet, and ShadowUNetPoseCond with its ``pose_fc.0``."""
    for i in range(4):
        _wn_conv(sd, f"{prefix}.enc_layers.{i}.0", p[f"enc{i}"])
        _wn_conv(sd, f"{prefix}.dec_layers.{i}.0", p[f"dec{i}"])
    _wn_conv(sd, f"{prefix}.shadow_pred", p["shadow_pred"])
    if "pose_fc" in p:
        _wn_linear(sd, f"{prefix}.pose_fc.0", p["pose_fc"])


def _inner(params: Mapping[str, Any]) -> Mapping[str, Any]:
    return params["params"] if "params" in params else params


def shadow_unet_state_dict_from_jax(params: Mapping[str, Any]) -> StateDict:
    """ShadowUNet / ShadowUNetPoseCond / DistMapShadowUNet params (``{"params":
    ...}`` or the inner tree) → the port's state_dict."""
    sd: StateDict = {}
    shadow_unet_state_dict(sd, "", _inner(params))
    return {k[1:]: v for k, v in sd.items()}


def floor_shadow_state_dict_from_jax(params: Mapping[str, Any]) -> StateDict:
    """FloorShadowDecoder: ``down_layers.{i}.0`` / ``up_layers.{i}.0`` / ``shadow_pred``."""
    p, sd = _inner(params), {}
    for i in range(3):
        _wn_conv(sd, f"down_layers.{i}.0", p[f"down{i}"])
        _wn_conv(sd, f"up_layers.{i}.0", p[f"up{i}"])
    _wn_conv(sd, "shadow_pred", p["shadow_pred"])
    return sd


def unet_state_dict_from_jax(params: Mapping[str, Any]) -> StateDict:
    """UNetWB / UNetWBConcat / UNetW params → the port's state_dict."""
    sd: StateDict = {}
    unet_wb_state_dict(sd, "", _inner(params))
    return {k[1:]: v for k, v in sd.items()}


def pose_to_shadow_state_dict(sd: StateDict, prefix: str, p: Mapping[str, Any]) -> None:
    """PoseToShadow: ``fc_block.0`` (a [256, 4, 4] output) + ``conv_block.{2i}``."""
    _wn_linear(sd, f"{prefix}.fc_block.0", p["fc_block"], chw_out=(256, 4, 4))
    for i in range(5):
        _wn_convt(sd, f"{prefix}.conv_block.{2 * i}", p[f"conv{i}"])


def face_decoder_state_dict(sd: StateDict, prefix: str, p: Mapping[str, Any]) -> None:
    """FaceDecoderFrontal: ``encmod.0`` ... ``texmod.{2i}``, ``bias`` [3, T, T]."""
    for n in ("encmod", "geommod", "viewmod"):
        _wn_linear(sd, f"{prefix}.{n}.0", p[n])
    _wn_linear(sd, f"{prefix}.texmod2.0", p["texmod2"], chw_out=(256, 4, 4))
    sd[f"{prefix}.bias"] = _a(np.asarray(p["bias"]).transpose(2, 0, 1))
    i = 0
    while f"texmod_up{i}" in p:
        _wn_convt(sd, f"{prefix}.texmod.{2 * i}", p[f"texmod_up{i}"])
        i += 1


def upscale_net_state_dict(sd: StateDict, prefix: str, p: Mapping[str, Any]) -> None:
    """The avatar's UpscaleNet: ``conv_block.0`` + ``out_block``."""
    _wn_conv(sd, f"{prefix}.conv_block.0", p["conv_block0"])
    _wn_conv(sd, f"{prefix}.out_block", p["out_block"])


def body_avatar_state_dict_from_jax(params: Mapping[str, Any], cfg) -> StateDict:
    """BodyAvatar params (``{"params": ...}`` or the inner tree) → the port's
    state_dict under the ca_body names that
    ``audio2photoreal_tpu/train/convert.py:convert_body_avatar`` reads.

    Block counts follow ``cfg`` (a RendererConfig of either package), so
    the small test configs convert as well as the production one.  The
    JAX tree has ``shadow_net`` only when its init ran the shadow UNet, and
    ``cal`` / ``learn_blur`` / ``pixel_cal`` only at ``n_cameras > 0``."""
    import math

    from audio2photoreal_tpu_torch.render.mesh_vae import _embs_plan, _face_plan

    p = _inner(params)
    sd: StateDict = {}
    enc = p["encoder"]
    _conv_block(sd, "encoder.verts_conv", enc["verts_conv"])
    for i in range(int(math.log2(cfg.encoder_in_size // 4)) - 1):
        _conv_block(sd, f"encoder.joint_conv_blocks.{i}", enc[f"joint{i}"])
    for n in ("mu", "logvar"):
        _wn_linear(sd, f"encoder.{n}", enc[n], chw_in=(128, 4, 4))

    fenc = p["encoder_face"]
    for i in range(int(math.log2(cfg.encoder_in_size // 4))):
        _conv_block(sd, f"encoder_face.conv_blocks.{i}", fenc[f"conv{i}"])
    _wn_linear(sd, "encoder_face.geommod.0", fenc["geommod"])
    _wn_linear(sd, "encoder_face.jointmod.0", fenc["jointmod"], chw_in=(128, 4, 4))
    _wn_linear(sd, "encoder_face.mu", fenc["mu"])
    _wn_linear(sd, "encoder_face.logvar", fenc["logvar"])

    face_decoder_state_dict(sd, "decoder_face", p["decoder_face"])

    dec = p["decoder"]
    S0 = cfg.init_uv_size
    _conv_block(sd, "decoder.local_pose_conv_block", dec["local_pose_conv_block"])
    _wn_linear(sd, "decoder.embs_fc.0", dec["embs_fc"], chw_out=(128, 4, 4))
    _wn_linear(sd, "decoder.face_embs_fc.0", dec["face_embs_fc"], chw_out=(32, 4, 4))
    for i in range(len(_embs_plan(S0, cfg.n_embs_enc_channels))):
        _conv_block(sd, f"decoder.embs_conv_block.{i}", dec[f"embs_conv{i}"])
    for i in range(len(_face_plan(S0, cfg.n_embs_enc_channels))):
        _conv_block(sd, f"decoder.face_embs_conv_block.{i}", dec[f"face_embs_conv{i}"])
    _conv_block(sd, "decoder.joint_conv_block", dec["joint_conv_block"])
    for b in range(int(math.log2(cfg.uv_size // S0))):
        _conv_block(sd, f"decoder.conv_blocks.{b}", dec[f"up{b}"])
    _wn_conv(sd, "decoder.verts_conv", dec["verts_conv"])
    _wn_conv(sd, "decoder.tex_conv", dec["tex_conv"])

    unet_wb_state_dict(sd, "decoder_view.unet", p["decoder_view"]["unet"])
    if "shadow_net" in p:
        shadow_unet_state_dict(sd, "shadow_net", p["shadow_net"])
    pose_to_shadow_state_dict(sd, "pose_to_shadow", p["pose_to_shadow"])
    upscale_net_state_dict(sd, "upscale_net", p["upscale_net"])
    if "cal" in p:  # the training calibration (n_cameras > 0)
        sd["cal.weight"], sd["cal.bias"] = _a(p["cal"]["weight"]), _a(p["cal"]["bias"])
        sd["learn_blur.weights"] = _a(p["learn_blur"]["weights"])
        sd["pixel_cal.bias"] = _a(np.asarray(p["pixel_cal"]["bias"]).transpose(0, 3, 1, 2))  # [N, h, w, 1]
    return sd
