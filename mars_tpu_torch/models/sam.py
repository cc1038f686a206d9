"""SAM (Segment Anything): image encoder, prompt encoder, two-way mask
decoder (port of ``mars_tpu/models/sam.py``).

Layouts as in the JAX package: token grids NHWC, dense kernels (in, out),
conv kernels HWIO, transposed-conv kernels (kh, kw, O, I); prompt batches
are fixed-shape, padded with label -1 ("not a point").

The encoder's global layers (a full grid of at least 1024 tokens, e.g. 64 ×
64 at ViT-H @1024) go through ``ops.sam_attention.grid_attention``: the
hand-written kernel on a CUDA tensor, its plain version on a CPU one.  The
windowed layers take plain PyTorch, as the JAX package's default XLA path
does, unless ``MARS_SAM_WINDOWED_IMPL=pallas`` (the JAX package's switch,
read at each call) sends them through ``ops.sam_attention.windowed_attention``,
every window-head of a layer in one launch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from mars_tpu_torch.core import imaging
from mars_tpu_torch.models import layers as L
from mars_tpu_torch.ops import sam_attention


@dataclass(frozen=True)
class SamConfig:
    img_size: int = 1024
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11)
    window_size: int = 14
    out_chans: int = 256
    mask_threshold: float = 0.0
    decoder_depth: int = 2
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048
    num_multimask_outputs: int = 3


# reference: segment_anything/build_sam.py:14-52
SAM_VARIANTS = {
    "vit_b": SamConfig(),
    "vit_l": SamConfig(embed_dim=1024, depth=24, num_heads=16,
                       global_attn_indexes=(5, 11, 17, 23)),
    "vit_h": SamConfig(embed_dim=1280, depth=32, num_heads=16,
                       global_attn_indexes=(7, 15, 23, 31)),
}

# normalisation in 0-255 pixel space (reference sam.py preprocess)
SAM_PIXEL_MEAN = (123.675, 116.28, 103.53)
SAM_PIXEL_STD = (58.395, 57.12, 57.375)


# ---------------------------------------------------------------------------
# image encoder
# ---------------------------------------------------------------------------

def _window_partition(x, ws: int):
    """(B, H, W, C) → (B·nWin, ws, ws, C), zero-padded; returns padded HW."""
    b, h, w, c = x.shape
    ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c), (hp, wp)


def _window_unpartition(x, ws: int, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = x.shape[0] // ((hp // ws) * (wp // ws))
    x = x.reshape(b, hp // ws, wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :h, :w]


def _rel_pos_table(rel_pos, q_size: int, k_size: int):
    """Interpolate/select the relative position table (reference
    image_encoder.py:292-323); linear resize with jax.image semantics."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        r = imaging.resize(rel_pos.float()[..., None], (max_rel_dist, rel_pos.shape[1]),
                           "bilinear")[..., 0]
    else:
        r = rel_pos
    dev = rel_pos.device
    q_coords = torch.arange(q_size, device=dev)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=dev)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return r[rel.long()]


WINDOWED_IMPL_ENV = "MARS_SAM_WINDOWED_IMPL"


def _grid_attention(p, x, num_heads: int, use_rel_pos: bool = True, route: str = "plain"):
    """Attention over a (B, H, W, C) token grid with decomposed rel pos
    (reference image_encoder.py:224-241, add_decomposed_rel_pos :325-366).
    ``route="global"``: a grid of at least 1024 tokens goes through
    ``sam_attention.grid_attention``, the same size route as the JAX
    package's ``allow_pallas``.  ``route="window"``: the batch of windows
    goes through ``sam_attention.windowed_attention`` when
    ``MARS_SAM_WINDOWED_IMPL=pallas``, as ``windowed_pallas`` does there."""
    b, h, w, c = x.shape
    hd = c // num_heads
    qkv = L.dense(p["qkv"], x).reshape(b, h * w, 3, num_heads, hd)
    q, k, v = qkv.unbind(dim=2)  # (B, HW, nh, hd)
    if use_rel_pos and route == "global" and h * w >= 1024:
        qt, kt, vt, bias_h, bias_w = _kernel_inputs(p, q, k, v, h, w)
        out = torch.stack([sam_attention.grid_attention(qt[i], kt[i], vt[i], bias_h[i],
                                                        bias_w[i], (h, w))
                           for i in range(b)])  # (B, nh, HW, hd)
        return L.dense(p["proj"], out.permute(0, 2, 1, 3).reshape(b, h, w, c))
    if use_rel_pos and route == "window" and L.kernel_switch(WINDOWED_IMPL_ENV):
        out = sam_attention.windowed_attention(*_kernel_inputs(p, q, k, v, h, w), (h, w))
        return L.dense(p["proj"], out.permute(0, 2, 1, 3).reshape(b, h, w, c))
    logits = torch.einsum("bqhd,bkhd->bhqk", q * hd ** -0.5, k)
    if use_rel_pos:
        bias_h, bias_w = _rel_pos_bias(p, q, h, w)
        logits = (logits.reshape(b, num_heads, h, w, h, w) + bias_h[..., :, None]
                  + bias_w[..., None, :]).reshape(b, num_heads, h * w, h * w)
    probs = torch.softmax(logits.float(), dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, h, w, c)
    return L.dense(p["proj"], out)


def _rel_pos_bias(p, q, h: int, w: int):
    """The decomposed rel-pos bias's two per-query tables from the UNscaled
    q (B, h·w, heads, hd) → bias_h (B, heads, h, w, h), bias_w (B, heads,
    h, w, w)."""
    b, _, num_heads, hd = q.shape
    rh = _rel_pos_table(p["rel_pos_h"], h, h).to(q.dtype)  # (h, h', hd)
    rw = _rel_pos_table(p["rel_pos_w"], w, w).to(q.dtype)  # (w, w', hd)
    rq = q.reshape(b, h, w, num_heads, hd)
    return (torch.einsum("bywhd,yYd->bhywY", rq, rh),
            torch.einsum("bywhd,wWd->bhywW", rq, rw))


def _kernel_inputs(p, q, k, v, h: int, w: int):
    """The attention kernels' inputs: q, k, v (B, HW, nh, hd) as contiguous
    (B, nh, HW, hd), and the rel-pos bias as its two per-query tables
    (B, nh, HW, h) and (B, nh, HW, w), expanded inside the kernels."""
    b, _, num_heads, _ = q.shape
    bias_h, bias_w = _rel_pos_bias(p, q, h, w)
    qt, kt, vt = (t.permute(0, 2, 1, 3).contiguous() for t in (q, k, v))
    return (qt, kt, vt, bias_h.reshape(b, num_heads, h * w, h).contiguous(),
            bias_w.reshape(b, num_heads, h * w, w).contiguous())


def _layer_norm_2d(p, x, eps: float = 1e-6):
    """Channel LayerNorm of an NHWC map (reference common.py LayerNorm2d),
    statistics in float32 (float64 for a float64 map)."""
    xf = x.to(L.stats_type(x.dtype))
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]).to(x.dtype)


def _conv(cp, x, stride: int = 1, padding: int = 0):
    """NHWC convolution with an HWIO kernel (and optional bias)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), cp["kernel"].permute(3, 2, 0, 1), stride=stride,
                 padding=padding).permute(0, 2, 3, 1)
    return y + cp["bias"] if "bias" in cp else y


def _conv_transpose(cp, x):
    """Stride-2 2x2 transposed convolution, NHWC, kernel stored (kh, kw, O, I)
    as ``jax.lax.conv_transpose(transpose_kernel=True)`` takes it; torch's
    ConvTranspose2d weight is (I, O, kh, kw)."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), cp["kernel"].permute(3, 2, 0, 1), stride=2)
    return y.permute(0, 2, 3, 1) + cp["bias"]


def encode_image(params, images, cfg: SamConfig):
    """images: (B, S, S, 3) SAM-normalised → (B, S/16, S/16, out_chans)."""
    b = images.shape[0]
    gh, gw = images.shape[1] // cfg.patch_size, images.shape[2] // cfg.patch_size
    x = L.conv_patch_embed(params["patch_embed"], images, cfg.patch_size)
    x = x.reshape(b, gh, gw, cfg.embed_dim)
    pos = params["pos_embed"]
    if pos.shape[1] != gh or pos.shape[2] != gw:
        pos = imaging.resize(pos.float(), (gh, gw), "bicubic")
    x = x + pos
    for i in range(cfg.depth):
        p = params[f"block{i}"]
        shortcut = x
        h = L.layer_norm(p["ln1"], x, eps=1e-6)
        if i not in cfg.global_attn_indexes:
            h, pad_hw = _window_partition(h, cfg.window_size)
            h = _grid_attention(p["attn"], h, cfg.num_heads, route="window")
            h = _window_unpartition(h, cfg.window_size, pad_hw, (gh, gw))
        else:
            h = _grid_attention(p["attn"], h, cfg.num_heads, route="global")
        x = shortcut + h
        x = x + L.mlp(p["mlp"], L.layer_norm(p["ln2"], x, eps=1e-6), L.exact_gelu)
    # neck: 1x1 conv → LN2d → 3x3 conv → LN2d (reference image_encoder.py:88-105)
    x = _layer_norm_2d(params["neck_ln1"], _conv(params["neck_conv1"], x))
    return _layer_norm_2d(params["neck_ln2"], _conv(params["neck_conv2"], x, padding=1))


# ---------------------------------------------------------------------------
# prompt encoder
# ---------------------------------------------------------------------------

def _pe_encoding(gauss, coords01):
    """Random-Fourier features of [0, 1] coords (reference
    prompt_encoder.py:186-194), sin/cos in float32 (float64 for float64
    weights)."""
    dt = L.stats_type(gauss.dtype)
    c = (2.0 * coords01.to(dt) - 1.0) @ gauss.to(dt)
    c = 2.0 * torch.pi * c
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1).to(gauss.dtype)


def dense_pe(params, grid_hw: Tuple[int, int]):
    """(H, W, embed_dim) positional grid (reference prompt_encoder.py:196-207)."""
    h, w = grid_hw
    dev = params["pe_gaussian"].device
    y = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    x = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    gy, gx = torch.meshgrid(y, x, indexing="ij")
    return _pe_encoding(params["pe_gaussian"], torch.stack([gx, gy], dim=-1))


def embed_points(params, coords, labels, input_size: Tuple[int, int], pad: bool):
    """coords (B, N, 2) xy in input pixels, labels (B, N) in {-1, 0, 1};
    label -1 → not_a_point (reference prompt_encoder.py:74-94); ``pad``
    appends one pad point."""
    if pad:
        b = coords.shape[0]
        coords = torch.cat([coords, coords.new_zeros((b, 1, 2))], dim=1)
        labels = torch.cat([labels, -labels.new_ones((b, 1))], dim=1)
    scale = torch.tensor([input_size[1], input_size[0]], dtype=torch.float32,
                         device=coords.device)
    pe = _pe_encoding(params["pe_gaussian"], (coords + 0.5) / scale)
    emb = params["point_embeddings"]  # (4, D): neg, pos, box tl, box br
    lab = labels[..., None]
    out = torch.where(lab == -1, params["not_a_point_embed"][0], pe)
    out = torch.where(lab == 0, pe + emb[0], out)
    return torch.where(lab == 1, pe + emb[1], out)


def embed_boxes(params, boxes, input_size: Tuple[int, int]):
    """boxes (B, 4) xyxy → (B, 2, D) corner embeddings (reference
    prompt_encoder.py:96-103)."""
    b = boxes.shape[0]
    scale = torch.tensor([input_size[1], input_size[0]], dtype=torch.float32,
                         device=boxes.device)
    pe = _pe_encoding(params["pe_gaussian"], (boxes.reshape(b, 2, 2) + 0.5) / scale)
    emb = params["point_embeddings"]
    return pe + torch.stack([emb[2], emb[3]])[None]


def embed_mask_input(params, masks):
    """(B, 4G, 4G) low-res mask logits → (B, G, G, D) (reference
    prompt_encoder.py:52-60 mask_downscaling)."""
    p = params["mask_downscale"]
    x = L.exact_gelu(_layer_norm_2d(p["ln1"], _conv(p["conv1"], masks[..., None], 2)))
    x = L.exact_gelu(_layer_norm_2d(p["ln2"], _conv(p["conv2"], x, 2)))
    return _conv(p["conv3"], x)


def no_mask_dense(params, grid_hw: Tuple[int, int]):
    e = params["no_mask_embed"][0]
    return e.expand(grid_hw[0], grid_hw[1], e.shape[-1])


# ---------------------------------------------------------------------------
# two-way transformer + mask decoder
# ---------------------------------------------------------------------------

def _attn(p, q, k, v, num_heads: int, key_valid=None, downsample: int = 1):
    """Projection attention (reference transformer.py:185-240) of internal
    width ``embedding / downsample``; ``key_valid`` (B, Nk) masks padded
    key tokens out of the softmax, so a prompt row padded to a common
    length decodes exactly as unpadded.  A layer that
    ``parallel.mesh.shard_params`` sliced (its q narrower than the internal
    width) computes the rank's whole heads and sums ``out``'s partial
    products over the model group, its bias added once."""
    hd = q.shape[-1] // downsample // num_heads
    width = L.out_features(p["q"])
    sliced = width < hd * num_heads
    if sliced:
        if width % hd:
            raise ValueError(f"a rank's attention width {width} holds no whole heads of {hd}")
        q, k, v = L.model_input(q), L.model_input(k), L.model_input(v)
    q, k, v = L.dense(p["q"], q), L.dense(p["k"], k), L.dense(p["v"], v)
    b, nq, c = q.shape
    heads = c // hd
    qh = q.reshape(b, nq, heads, hd)
    kh = k.reshape(b, k.shape[1], heads, hd)
    vh = v.reshape(b, v.shape[1], heads, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / (hd ** 0.5)
    if key_valid is not None:
        logits = logits.masked_fill(~key_valid[:, None, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vh).reshape(b, nq, c)
    return L.dense_reduce(p["out"], out, sliced)


def _two_way_block(p, queries, keys, query_pe, key_pe, num_heads: int, skip_first_pe: bool,
                   token_valid=None):
    if skip_first_pe:
        queries = _attn(p["self_attn"], queries, queries, queries, num_heads,
                        key_valid=token_valid)
    else:
        q = queries + query_pe
        queries = queries + _attn(p["self_attn"], q, q, queries, num_heads,
                                  key_valid=token_valid)
    queries = L.layer_norm(p["norm1"], queries)
    q, k = queries + query_pe, keys + key_pe
    queries = L.layer_norm(p["norm2"], queries + _attn(p["cross_attn_t2i"], q, k, keys,
                                                       num_heads, downsample=2))
    h = L.mlp(p["mlp"], queries, torch.relu,
              L.out_features(p["self_attn"]["q"]) < queries.shape[-1])
    queries = L.layer_norm(p["norm3"], queries + h)
    q, k = queries + query_pe, keys + key_pe
    keys = keys + _attn(p["cross_attn_i2t"], k, q, queries, num_heads, key_valid=token_valid,
                        downsample=2)
    return queries, L.layer_norm(p["norm4"], keys)


def _mlp_head(p, x, depth: int):
    for j in range(depth):
        x = L.dense(p[f"layer{j}"], x)
        if j < depth - 1:
            x = torch.relu(x)
    return x


def decode_masks(params, image_embedding, image_pe, sparse_prompts, dense_prompts,
                 cfg: SamConfig, sparse_valid=None):
    """(B, 4, 4G, 4G) mask logits + (B, 4) IoU predictions for B prompt sets
    against one (G, G, C) image embedding, or against a (B, G, G, C) stack,
    one embedding a prompt set (reference mask_decoder.py:112-176; the rows
    never meet).  ``sparse_valid`` (B, N) masks pad prompt tokens out of
    attention.  Decoder layers that ``parallel.mesh.shard_params`` sliced
    run inside ``layers.tensor_parallel``."""
    d = params
    b = sparse_prompts.shape[0]
    g, c = image_embedding.shape[-3], image_embedding.shape[-1]
    num_mask_tokens = cfg.num_multimask_outputs + 1
    output_tokens = torch.cat([d["iou_token"], d["mask_tokens"]], dim=0)
    tokens = torch.cat([output_tokens.expand(b, *output_tokens.shape), sparse_prompts], dim=1)
    src = (image_embedding if image_embedding.dim() == 4
           else image_embedding[None].expand(b, g, g, c))
    if dense_prompts is not None:
        src = src + dense_prompts
    src = src.reshape(b, g * g, c)
    pos = image_pe[None].expand(b, g, g, c).reshape(b, g * g, c)
    token_valid = None
    if sparse_valid is not None:
        token_valid = torch.cat([sparse_valid.new_ones((b, 1 + num_mask_tokens)),
                                 sparse_valid], dim=1)

    queries, keys = tokens, src
    t = d["transformer"]
    for i in range(cfg.decoder_depth):
        queries, keys = _two_way_block(t[f"layer{i}"], queries, keys, tokens, pos,
                                       cfg.decoder_heads, i == 0, token_valid=token_valid)
    q, k = queries + tokens, keys + pos
    queries = L.layer_norm(t["norm_final"],
                           queries + _attn(t["final_attn"], q, k, keys, cfg.decoder_heads,
                                           downsample=2))
    iou_token_out = queries[:, 0]
    mask_tokens_out = queries[:, 1:1 + num_mask_tokens]

    # upscale 4x with two stride-2 transposed convs (reference :53-59)
    x = _conv_transpose(d["upscale_conv1"], keys.reshape(b, g, g, c))
    x = L.exact_gelu(_layer_norm_2d(d["upscale_ln"], x))
    x = L.exact_gelu(_conv_transpose(d["upscale_conv2"], x))  # (B, 4G, 4G, C/8)
    hyper_in = torch.stack([_mlp_head(d["hypernetworks"][f"mlp{i}"], mask_tokens_out[:, i], 3)
                            for i in range(num_mask_tokens)], dim=1)  # (B, 4, C/8)
    masks = torch.einsum("bmc,bhwc->bmhw", hyper_in, x)
    return masks, _mlp_head(d["iou_head"], iou_token_out, len(d["iou_head"]))


def postprocess_masks(masks, encoder_input_size: int, original_hw: Tuple[int, int]):
    """(..., 4G, 4G) logits → (..., H, W) at the original size (reference
    sam.py:133-160): bilinear resize to the encoder input (jax.image
    semantics, antialiased when shrinking), crop the unpadded region,
    resize to the original size."""
    s = encoder_input_size
    up = imaging.resize_2d(masks, (s, s), "bilinear")
    scale = s / max(original_hw)
    up = up[..., :int(round(original_hw[0] * scale)), :int(round(original_hw[1] * scale))]
    return imaging.resize_2d(up, tuple(original_hw), "bilinear")


def transform_coords(coords, original_hw: Tuple[int, int], encoder_input_size: int):
    """ResizeLongestSide.apply_coords (reference utils/transforms.py)."""
    oh, ow = original_hw
    scale = encoder_input_size / max(oh, ow)
    new_h, new_w = int(oh * scale + 0.5), int(ow * scale + 0.5)
    return coords * torch.tensor([new_w / ow, new_h / oh], dtype=torch.float32,
                                 device=coords.device)


# ---------------------------------------------------------------------------
# parameter shapes (models.zoo draws seeded random weights from them)
# ---------------------------------------------------------------------------

def _dense_shape(i: int, o: int) -> dict:
    return {"kernel": (i, o), "bias": (o,)}


def _ln_shape(d: int) -> dict:
    return {"scale": (d,), "bias": (d,)}


def encoder_param_shapes(cfg: SamConfig) -> dict:
    """Keyed as ``mars_tpu.models.sam.init_encoder_params``."""
    e, g, o = cfg.embed_dim, cfg.img_size // cfg.patch_size, cfg.out_chans
    p = {
        "patch_embed": {"kernel": (cfg.patch_size, cfg.patch_size, 3, e), "bias": (e,)},
        "pos_embed": (1, g, g, e),
        "neck_conv1": {"kernel": (1, 1, e, o)},
        "neck_ln1": _ln_shape(o),
        "neck_conv2": {"kernel": (3, 3, o, o)},
        "neck_ln2": _ln_shape(o),
    }
    hd = e // cfg.num_heads
    for i in range(cfg.depth):
        blk = L.block_shapes(e, 4 * e)
        size = g if i in cfg.global_attn_indexes else cfg.window_size
        blk["attn"]["rel_pos_h"] = (2 * size - 1, hd)
        blk["attn"]["rel_pos_w"] = (2 * size - 1, hd)
        p[f"block{i}"] = blk
    return p


def prompt_encoder_param_shapes(cfg: SamConfig) -> dict:
    """Keyed as ``mars_tpu.models.sam.init_prompt_encoder_params``."""
    d, mic = cfg.out_chans, 16
    return {
        "pe_gaussian": (2, d // 2),
        "not_a_point_embed": (1, d),
        "no_mask_embed": (1, d),
        "point_embeddings": (4, d),
        "mask_downscale": {
            "conv1": {"kernel": (2, 2, 1, mic // 4), "bias": (mic // 4,)},
            "ln1": _ln_shape(mic // 4),
            "conv2": {"kernel": (2, 2, mic // 4, mic), "bias": (mic,)},
            "ln2": _ln_shape(mic),
            "conv3": {"kernel": (1, 1, mic, d), "bias": (d,)},
        },
    }


def decoder_param_shapes(cfg: SamConfig) -> dict:
    """Keyed as ``mars_tpu.models.sam.init_decoder_params``."""
    d, m = cfg.out_chans, cfg.num_multimask_outputs + 1

    def attn(internal):
        return {"q": _dense_shape(d, internal), "k": _dense_shape(d, internal),
                "v": _dense_shape(d, internal), "out": _dense_shape(internal, d)}

    t = {}
    for i in range(cfg.decoder_depth):
        t[f"layer{i}"] = {
            "self_attn": attn(d), "norm1": _ln_shape(d),
            "cross_attn_t2i": attn(d // 2), "norm2": _ln_shape(d),
            "mlp": {"fc1": _dense_shape(d, cfg.decoder_mlp_dim),
                    "fc2": _dense_shape(cfg.decoder_mlp_dim, d)},
            "norm3": _ln_shape(d),
            "cross_attn_i2t": attn(d // 2), "norm4": _ln_shape(d),
        }
    t["final_attn"] = attn(d // 2)
    t["norm_final"] = _ln_shape(d)
    return {
        "iou_token": (1, d),
        "mask_tokens": (m, d),
        "transformer": t,
        "upscale_conv1": {"kernel": (2, 2, d // 4, d), "bias": (d // 4,)},
        "upscale_ln": _ln_shape(d // 4),
        "upscale_conv2": {"kernel": (2, 2, d // 8, d // 4), "bias": (d // 8,)},
        "hypernetworks": {f"mlp{i}": {"layer0": _dense_shape(d, d), "layer1": _dense_shape(d, d),
                                      "layer2": _dense_shape(d, d // 8)} for i in range(m)},
        "iou_head": {"layer0": _dense_shape(d, 256), "layer1": _dense_shape(256, 256),
                     "layer2": _dense_shape(256, m)},
    }


def param_shapes(cfg: SamConfig) -> dict:
    return {"encoder": encoder_param_shapes(cfg),
            "prompt_encoder": prompt_encoder_param_shapes(cfg),
            "decoder": decoder_param_shapes(cfg)}

