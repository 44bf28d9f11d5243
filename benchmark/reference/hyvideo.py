"""Plain float32 reference of one HunyuanVideo text-to-video denoising
step.

Written from the published HunyuanVideo architecture
(``Tencent/HunyuanVideo``'s ``hyvideo/modules/models.py``: the patch
embedding, the token refiner over the LLM text states, the time, pooled
CLIP-text and embedded-guidance vectors, 20 double-stream blocks with
joint image-text attention, 40 single-stream blocks with the fused
projections, 3-D RoPE over (16, 56, 56) at theta 256 on the image tokens,
per-head q/k RMS norms, the modulated final layer) and the Jenga carving
of the joint attention: the image tokens in the gilbert curve's order,
the planner's selection for the video query rows (the text key blocks
always on), the text rows dense, keys past the real text masked.

Weights come one group at a time from ``traffic.weights``, the same
seeded draws the program was given, in float32 only while their group
runs. Nothing of the program under test is imported.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import common as C


def param_groups(cfg: dict):
    """Ordered [(group, [(name, shape, kind, f32), ...])] of the model."""
    d, hd = cfg["hidden_size"], cfg["hidden_size"] // cfg["heads_num"]
    mh = int(d * cfg["mlp_ratio"])
    p = cfg["patch_size"]
    patch = p[0] * p[1] * p[2]

    def aff(name, d_in, d_out, f32=False, bias=True):
        out = [(f"{name}.w", (d_out, d_in), "w", f32)]
        return out + [(f"{name}.b", (d_out,), "b", f32)] if bias else out

    def mlp(name, d_in, d_hid, d_out, f32=False):
        return aff(f"{name}.fc1", d_in, d_hid, f32) + aff(
            f"{name}.fc2", d_hid, d_out, f32)

    def norm(name, n):
        return [(f"{name}.w", (n,), "ln", True),
                (f"{name}.b", (n,), "b", True)]

    embed = aff("img_in", cfg["in_channels"] * patch, d)
    embed += aff("txt_in.input_embedder", cfg["text_states_dim"], d)
    embed += mlp("txt_in.t_embedder", 256, d, d, True)
    embed += mlp("txt_in.c_embedder", cfg["text_states_dim"], d, d)
    for i in range(cfg["refiner_depth"]):
        r = f"txt_in.blocks.{i}"
        embed += (norm(f"{r}.norm1", d) + aff(f"{r}.qkv", d, 3 * d)
                  + aff(f"{r}.proj", d, d) + norm(f"{r}.norm2", d)
                  + mlp(f"{r}.mlp", d, mh, d) + aff(f"{r}.adaLN", d, 2 * d,
                                                   True))
    embed += mlp("time_in", 256, d, d, True)
    embed += mlp("vector_in", cfg["text_states_dim_2"], d, d, True)
    if cfg["guidance_embed"]:
        embed += mlp("guidance_in", 256, d, d, True)
    groups = [("embed", embed)]
    bias = cfg["qkv_bias"]
    for i in range(cfg["double_blocks"]):
        b = f"double_blocks.{i}"
        g = []
        for s in ("img", "txt"):
            g += aff(f"{b}.{s}_mod", d, 6 * d, True)
            g += aff(f"{b}.{s}_qkv", d, 3 * d, bias=bias)
        g += [(f"{b}.{n}", (hd,), "ln", True) for n in (
            "img_q_norm", "img_k_norm", "txt_q_norm", "txt_k_norm")]
        for s in ("img", "txt"):
            g += aff(f"{b}.{s}_proj", d, d, bias=bias)
            g += mlp(f"{b}.{s}_mlp", d, mh, d)
        groups.append((f"double.{i}", g))
    for i in range(cfg["single_blocks"]):
        b = f"single_blocks.{i}"
        groups.append((f"single.{i}", (
            aff(f"{b}.modulation", d, 3 * d, True)
            + aff(f"{b}.linear1", d, 3 * d + mh)
            + aff(f"{b}.linear2", d + mh, d)
            + [(f"{b}.q_norm", (hd,), "ln", True),
               (f"{b}.k_norm", (hd,), "ln", True)])))
    groups.append(("head", aff("final_layer.linear", d, patch
                               * cfg["out_channels"])
                   + aff("final_layer.adaLN", d, 2 * d, True)))
    return groups


def _aff(w, name, x):
    return C.linear(x, w[name + ".w"], w.get(name + ".b"))


def _mlp(w, name, x, act):
    return _aff(w, name + ".fc2", act(_aff(w, name + ".fc1", x)))


def _refiner(w, cfg, txt, t, mask):
    d, n = cfg["hidden_size"], cfg["heads_num"]
    hd = d // n
    b, s, _ = txt.shape
    t_emb = _mlp(w, "txt_in.t_embedder", C.sinusoidal(256, t), F.silu)
    mf = mask.float()[..., None]
    pooled = (txt * mf).sum(1) / mf.sum(1).clamp_min(1.0)
    c = t_emb + _mlp(w, "txt_in.c_embedder", pooled, F.silu)
    x = _aff(w, "txt_in.input_embedder", txt)
    m = mask.bool()
    am = m[:, None, :] & m[:, :, None]
    am[:, :, 0] = True
    for i in range(cfg["refiner_depth"]):
        r = f"txt_in.blocks.{i}"
        gate = _aff(w, f"{r}.adaLN", F.silu(c))
        g_msa, g_mlp = gate[:, None, :d], gate[:, None, d:]
        nx = C.layer_norm(x, w[f"{r}.norm1.w"], w[f"{r}.norm1.b"])
        qkv = _aff(w, f"{r}.qkv", nx).reshape(b, s, 3, n, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", qkv[:, :, 0],
                              qkv[:, :, 1]) * hd ** -0.5
        pa = torch.softmax(logits.masked_fill(~am[:, None], float("-inf")),
                           dim=-1)
        att = torch.einsum("bhqk,bkhd->bqhd", pa, qkv[:, :, 2])
        x = x + _aff(w, f"{r}.proj", att.reshape(b, s, d)) * g_msa
        y = C.layer_norm(x, w[f"{r}.norm2.w"], w[f"{r}.norm2.b"])
        x = x + _mlp(w, f"{r}.mlp", y, F.silu) * g_mlp
    return x


def _joint_attention(q, k, v, plan, seqlens):
    """Carved joint attention of q, k, v [B, S_img + S_txt, H, D]."""
    b, s, n, hd = q.shape
    s_pad = -(-s // C.BLOCK) * C.BLOCK
    qt, kt, vt = (F.pad(x, (0, 0, 0, 0, 0, s_pad - s)).transpose(1, 2)
                  for x in (q, k, v))
    nb = s_pad // C.BLOCK
    tsb = nb - plan["txt_blocks"]
    sel = C.select_blocks(qt[:, :, :tsb * C.BLOCK], kt, top_k=plan["top_k"],
                          p_remain=plan["p_remain"], video_blocks=tsb,
                          text_blocks=plan["txt_blocks"],
                          neighbors=plan["neighbors"], group=plan["group"])
    full = torch.ones((b, n, nb - tsb, nb), dtype=torch.bool,
                      device=q.device)
    out = C.sparse_attention(qt, kt, vt, torch.cat([sel, full], dim=2),
                             seqlen=seqlens, group=plan["group"],
                             text_start_block=tsb,
                             text_amp=plan["text_amp"])
    return out.transpose(1, 2)[:, :s].reshape(b, s, n * hd)


def _mod(x, shift, scale):
    return C.layer_norm(x) * (1 + scale) + shift


def _double(w, i, img, txt, vec, plan, seqlens, cfg):
    d, n = cfg["hidden_size"], cfg["heads_num"]
    hd = d // n
    pre = f"double_blocks.{i}."
    im = _aff(w, pre + "img_mod", F.silu(vec))[:, None].chunk(6, dim=-1)
    tm = _aff(w, pre + "txt_mod", F.silu(vec))[:, None].chunk(6, dim=-1)
    b, si, _ = img.shape
    st = txt.shape[1]
    iq = _aff(w, pre + "img_qkv", _mod(img, im[0], im[1])).reshape(
        b, si, 3, n, hd)
    tq = _aff(w, pre + "txt_qkv", _mod(txt, tm[0], tm[1])).reshape(
        b, st, 3, n, hd)
    q = torch.cat([C.rope(C.rms_norm(iq[:, :, 0], w[pre + "img_q_norm"]),
                          plan["cos"], plan["sin"]),
                   C.rms_norm(tq[:, :, 0], w[pre + "txt_q_norm"])], dim=1)
    k = torch.cat([C.rope(C.rms_norm(iq[:, :, 1], w[pre + "img_k_norm"]),
                          plan["cos"], plan["sin"]),
                   C.rms_norm(tq[:, :, 1], w[pre + "txt_k_norm"])], dim=1)
    v = torch.cat([iq[:, :, 2], tq[:, :, 2]], dim=1)
    del iq, tq
    att = _joint_attention(q, k, v, plan, seqlens)
    del q, k, v
    img = img + _aff(w, pre + "img_proj", att[:, :si]) * im[2]
    img = img + _mlp(w, pre + "img_mlp", _mod(img, im[3], im[4]),
                     C.gelu_tanh) * im[5]
    txt = txt + _aff(w, pre + "txt_proj", att[:, si:]) * tm[2]
    txt = txt + _mlp(w, pre + "txt_mlp", _mod(txt, tm[3], tm[4]),
                     C.gelu_tanh) * tm[5]
    return img, txt


def _single(w, i, x, vec, plan, seqlens, cfg, img_len):
    d, n = cfg["hidden_size"], cfg["heads_num"]
    hd = d // n
    pre = f"single_blocks.{i}."
    b, s, _ = x.shape
    shift, scale, gate = _aff(w, pre + "modulation", F.silu(vec))[
        :, None].chunk(3, dim=-1)
    y = _aff(w, pre + "linear1", _mod(x, shift, scale))
    qkv, mlp = y[..., :3 * d].reshape(b, s, 3, n, hd), y[..., 3 * d:]
    del y
    q = C.rms_norm(qkv[:, :, 0], w[pre + "q_norm"])
    k = C.rms_norm(qkv[:, :, 1], w[pre + "k_norm"])
    q = torch.cat([C.rope(q[:, :img_len], plan["cos"], plan["sin"]),
                   q[:, img_len:]], dim=1)
    k = torch.cat([C.rope(k[:, :img_len], plan["cos"], plan["sin"]),
                   k[:, img_len:]], dim=1)
    att = _joint_attention(q, k, qkv[:, :, 2], plan, seqlens)
    del q, k, qkv
    out = _aff(w, pre + "linear2", torch.cat([att, C.gelu_tanh(mlp)], -1))
    return x + out * gate


def make_plan(cfg: dict, grid, curve_plan, *, drop: float, p_remain: float,
              group: int, txt_blocks: int, text_amp: float = 0.0):
    """The carving constants of an image token grid."""
    cos, sin = C.rope_tables(grid, cfg["rope_dim_list"], cfg["rope_theta"],
                             order=curve_plan.curve_order)
    s = grid[0] * grid[1] * grid[2]
    return dict(order=torch.as_tensor(curve_plan.curve_order).long(),
                inverse=torch.as_tensor(curve_plan.linear_to_curve).long(),
                neighbors=torch.as_tensor(curve_plan.block_neighbors),
                cos=cos, sin=sin, p_remain=p_remain, group=group,
                txt_blocks=txt_blocks, text_amp=text_amp,
                top_k=int((1.0 - drop) * (s // C.BLOCK)))


@torch.no_grad()
def velocity(weights, cfg: dict, x, t: float, text, mask, text2, plan, *,
             guidance: float, device):
    """The velocity [C, F, H, W] float32 of latents x [C, F, H, W] at
    timestep ``t`` (batch 1, embedded guidance ``guidance``); ``text``
    [L, 4096] with ``mask`` [L], ``text2`` [768]; ``weights(group)``
    returns a group's tensors."""
    plan = {k: (v.to(device) if torch.is_tensor(v) else v)
            for k, v in plan.items()}
    p = cfg["patch_size"]
    w = weights("embed")
    xb = x[None].float().to(device)
    b, c, f, h, wd = xb.shape
    grid = (f // p[0], h // p[1], wd // p[2])
    xp = xb.reshape(b, c, grid[0], p[0], grid[1], p[1], grid[2], p[2])
    xp = xp.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(b, -1, c * p[0] * p[1]
                                                    * p[2])
    img = _aff(w, "img_in", xp)
    tt = torch.full((1,), float(t), device=device)
    vec = _mlp(w, "time_in", C.sinusoidal(256, tt), F.silu)
    vec = vec + _mlp(w, "vector_in", text2[None].float().to(device), F.silu)
    if cfg["guidance_embed"]:
        g = torch.full((1,), float(guidance), device=device)
        vec = vec + _mlp(w, "guidance_in", C.sinusoidal(256, g), F.silu)
    mask = mask[None].to(device)
    txt = _refiner(w, cfg, text[None].float().to(device), tt, mask)
    del w
    img = img[:, plan["order"]]
    si = img.shape[1]
    seqlens = (si + mask.int().sum(-1)).tolist()
    for i in range(cfg["double_blocks"]):
        img, txt = _double(weights(f"double.{i}"), i, img, txt, vec, plan,
                           seqlens, cfg)
    x1 = torch.cat([img, txt], dim=1)
    del img, txt
    for i in range(cfg["single_blocks"]):
        x1 = _single(weights(f"single.{i}"), i, x1, vec, plan, seqlens, cfg,
                     si)
    w = weights("head")
    img = x1[:, :si][:, plan["inverse"]]
    m = _aff(w, "final_layer.adaLN", F.silu(vec))
    d = cfg["hidden_size"]
    y = _aff(w, "final_layer.linear", _mod(img, m[:, None, :d],
                                           m[:, None, d:]))
    oc = cfg["out_channels"]
    y = y.reshape(b, *grid, oc, *p).permute(0, 4, 1, 5, 2, 6, 3, 7)
    return y.reshape(b, oc, f, h, wd)[0]


def flow_sigmas(steps: int, shift: float) -> np.ndarray:
    """The shifted flow-matching sigmas, 1 -> 0, held in float32."""
    s = np.linspace(1.0, 0.0, steps + 1, dtype=np.float64)
    return (shift * s / (1.0 + (shift - 1.0) * s)).astype(np.float32)
