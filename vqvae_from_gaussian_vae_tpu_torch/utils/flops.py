"""Analytic FLOP counts for roofline accounting (copies of the JAX package's
``utils/flops.py`` functions the port needs)."""

from __future__ import annotations

from typing import Dict


def conv2d_flops(h: int, w: int, cin: int, cout: int, k: int = 3) -> float:
    return 2.0 * h * w * cin * cout * k * k


def attn_flops(tokens: int, channels: int) -> float:
    # qkv+proj projections + 2 attention matmuls (single head)
    return 2.0 * tokens * channels * channels * 4 + 2.0 * 2.0 * tokens * tokens * channels


def unet_encoder_flops(cfg: Dict) -> float:
    ch = cfg["ch"]
    ch_mult = list(cfg["ch_mult"])
    res = cfg["resolution"]
    n_blocks = cfg["num_res_blocks"]
    attn_res = set(cfg.get("attn_resolutions", []))
    zc = cfg["z_channels"] * (2 if cfg.get("double_z", True) else 1)
    total = conv2d_flops(res, res, cfg.get("in_channels", 3), ch)
    in_mult = [1] + ch_mult
    cur = res
    for i, mult in enumerate(ch_mult):
        cin, cout = ch * in_mult[i], ch * mult
        for _ in range(n_blocks):
            total += conv2d_flops(cur, cur, cin, cout) + conv2d_flops(cur, cur, cout, cout)
            if cin != cout:
                total += conv2d_flops(cur, cur, cin, cout, k=1)
            cin = cout
            if cur in attn_res:
                total += attn_flops(cur * cur, cout)
        if i != len(ch_mult) - 1:
            total += conv2d_flops(cur // 2, cur // 2, cout, cout)
            cur //= 2
    c_mid = ch * ch_mult[-1]
    total += 2 * (2 * conv2d_flops(cur, cur, c_mid, c_mid))
    total += conv2d_flops(cur, cur, c_mid, zc)
    return total


def unet_decoder_flops(cfg: Dict) -> float:
    ch = cfg["ch"]
    ch_mult = list(cfg["ch_mult"])
    res = cfg["resolution"]
    n_blocks = cfg["num_res_blocks"] + 1
    attn_res = set(cfg.get("attn_resolutions", []))
    cur = res // 2 ** (len(ch_mult) - 1)
    block_in = ch * ch_mult[-1]
    total = conv2d_flops(cur, cur, cfg["z_channels"], block_in)
    total += 2 * (2 * conv2d_flops(cur, cur, block_in, block_in))
    for i in reversed(range(len(ch_mult))):
        block_out = ch * ch_mult[i]
        for _ in range(n_blocks):
            total += conv2d_flops(cur, cur, block_in, block_out) + conv2d_flops(cur, cur, block_out, block_out)
            if block_in != block_out:
                total += conv2d_flops(cur, cur, block_in, block_out, k=1)
            block_in = block_out
            if cur in attn_res:
                total += attn_flops(cur * cur, block_out)
        if i != 0:
            cur *= 2
            total += conv2d_flops(cur, cur, block_out, block_out)
    total += conv2d_flops(res, res, ch * ch_mult[0], cfg.get("out_ch", 3))
    return total


def gq_search_flops(rows: int, group: int, n_samples: int) -> float:
    """One (R, 2G) x (2G, N) product."""
    return 2.0 * rows * 2 * group * n_samples


def _vit_trunk_flops(cfg: Dict) -> float:
    p = cfg["patch_size"]
    l = (cfg["image_size"] // p) ** 2
    w = cfg["width"]
    layers = cfg["layers"]
    mlp = cfg.get("mlp_ratio", 4.0)
    per_layer = (2.0 * l * w * w * 4 + 2.0 * 2.0 * l * l * w
                 + 2.0 * l * w * (w * mlp) * 2)
    return layers * per_layer


def vit_flops(cfg: Dict) -> float:
    """Encoder-side ViT forward: trunk + patch projection + quant head
    (models/vit.py TransformerEncoder)."""
    p = cfg["patch_size"]
    l = (cfg["image_size"] // p) ** 2
    w = cfg["width"]
    z = cfg.get("z_channels", 0)
    quant = 2.0 * l * w * (2 * z if cfg.get("double_z", True) else z)
    return _vit_trunk_flops(cfg) + 2.0 * l * (3 * p * p) * w + quant


def vit_decoder_flops(cfg: Dict) -> float:
    """Decoder-side ViT forward: post_quant_embed + trunk + tanh-FFN output
    head + conv_out patch head (models/vit.py TransformerDecoder)."""
    p = cfg["patch_size"]
    l = (cfg["image_size"] // p) ** 2
    w = cfg["width"]
    z = cfg.get("z_channels", 0)
    out_feats = 3 * p * p
    heads = 2.0 * l * z * w  # post_quant_embed
    if cfg.get("use_ffn_output", True):
        ffn = cfg.get("dim_ffn_output", 3072)
        heads += 2.0 * l * w * ffn + 2.0 * l * ffn * out_feats
    else:
        heads += 2.0 * l * w * out_feats
    return _vit_trunk_flops(cfg) + heads


def vit_layernorm_elems(cfg: Dict) -> float:
    """Elements through LayerNorm sites in ONE ViT trunk forward
    (models/vit.py): ln_1 + ln_2 per ResidualAttentionBlock plus
    ln_pre/ln_post.  Each site reads and writes its (L, W) activation
    once, so the bandwidth floor is elems * bytes/elem * 2 / HBM_BW."""
    p = cfg["patch_size"]
    l = (cfg["image_size"] // p) ** 2
    return (2 * cfg["layers"] + 2) * l * cfg["width"]


def vgg16_flops(h: int, w: int) -> float:
    """LPIPS VGG16 trunk forward (losses/lpips.py; torchvision layout).
    The 1x1 heads are negligible."""
    total, cin = 0.0, 3
    for width, n in ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3)):
        for _ in range(n):
            total += conv2d_flops(h, w, cin, width)
            cin = width
        h, w = h // 2, w // 2
    return total


def nlayer_disc_flops(h: int, w: int, ndf: int = 160, n_layers: int = 6,
                      in_ch: int = 3) -> float:
    """PatchGAN discriminator forward (losses/discriminator.py, pix2pix
    layout: 4x4 convs, n_layers stride-2 then one stride-1 + 1-ch head)."""
    total = conv2d_flops(h // 2, w // 2, in_ch, ndf, k=4)
    nf_prev, cur_h, cur_w = 1, h // 2, w // 2
    for n in range(1, n_layers):
        nf = min(2 ** n, 8)
        cur_h, cur_w = cur_h // 2, cur_w // 2
        total += conv2d_flops(cur_h, cur_w, ndf * nf_prev, ndf * nf, k=4)
        nf_prev = nf
    nf = min(2 ** n_layers, 8)
    total += conv2d_flops(cur_h, cur_w, ndf * nf_prev, ndf * nf, k=4)
    total += conv2d_flops(cur_h, cur_w, ndf * nf, 1, k=4)
    return total


def vit_train_attention_extra(cfg: Dict, *, trainable: bool = True) -> float:
    """Extra time-equivalent FLOPs a ViT trunk's attention costs on a
    128x128 systolic matrix unit (the JAX package's TPU accounting): per
    head, a matmul with head dim D < 128 runs at D/128 of peak, and the
    flash backward recomputes q k^T.  With m = 2 L^2 w per layer and
    r = 128 / min(D, 128): forward extra 2 (r - 1) m, backward extra
    (5 r - 4) m.  Kept for comparison with the JAX package's figures; the
    H100's tensor cores have no such 128-wide penalty."""
    p = cfg["patch_size"]
    l = (cfg["image_size"] // p) ** 2
    w = cfg["width"]
    d_head = w // cfg.get("heads", cfg.get("num_heads", 12))
    m = cfg["layers"] * 2.0 * l * l * w
    r = 128.0 / min(d_head, 128)
    extra = 2.0 * (r - 1.0) * m
    if trainable:
        extra += (5.0 * r - 4.0) * m
    return extra


def gan_train_step_flops_from_backbone(enc: float, dec: float, *, img: int = 256,
                                       ndf: int = 160, n_layers: int = 6,
                                       adaptive: bool = True) -> Dict[str, float]:
    """Per-image FLOPs of the two GAN phases (parallel/train_step.py) for
    encoder / decoder forward FLOPs ``enc`` / ``dec``: trainable nets cost
    3x their forward (dgrad + wgrad); frozen nets on the loss path 2x on the
    gradient branch and 1x on pure-input branches; the adaptive weight's
    two extra gradients cost LPIPS and disc fwd + dgrad once more."""
    lpips = vgg16_flops(img, img)
    disc = nlayer_disc_flops(img, img, ndf, n_layers)
    ae = 3.0 * (enc + dec)            # engine fwd + bwd
    ae += lpips                       # LPIPS(x): forward only
    ae += 2.0 * lpips                 # LPIPS(xrec): fwd + dgrad back to xrec
    ae += 2.0 * disc                  # g_loss disc(xrec): fwd + dgrad
    adaptive_extra = 2.0 * lpips + 2.0 * disc if adaptive else 0.0
    disc_phase = (enc + dec)          # fresh xrec, no grad
    disc_phase += 2.0 * 3.0 * disc    # disc(x) and disc(xrec), trained
    return {
        "ae_step": ae + adaptive_extra,
        "ae_step_no_adaptive": ae,
        "adaptive_extra": adaptive_extra,
        "disc_step": disc_phase,
        "pair_avg": (ae + adaptive_extra + disc_phase) / 2.0,
    }
