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
