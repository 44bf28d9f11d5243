"""Plain float32 reference of one Wan2.1 text-to-video denoising step.

Written from the published Wan2.1 architecture (``Wan-AI/Wan2.1``'s
``wan/modules/model.py``: patch embedding, sinusoidal time embedding and
its six-way projection, UMT5 text embedding, 30 blocks of modulated
self-attention with 3-D RoPE and full-width q/k RMS norms, cross-attention
over the 512 text tokens, a tanh-GELU MLP, and the modulated head) and
the Jenga carving of the self-attention: the tokens in the curve's order,
padded to 128-token blocks, the planner's block selection at every layer,
attention over the selected blocks only. Classifier-free guidance runs
the prompt and the null prompt as a batch of 2.

Weights come one group at a time from ``traffic.weights`` (the embeddings,
each block, the head), the same seeded draws the program was given, and
are held in float32 only while their group runs, so the whole step fits
beside its activations. Nothing of the program under test is imported.
"""

from __future__ import annotations

import math

import torch

from . import common as C

# (name, shape, kind): kind "w" linear weight, "b" bias, "ln" norm scale,
# "mod" modulation table; "32" marks the parameters the model holds in
# float32 (the rest are held in the configuration's dtype)


def param_groups(cfg: dict):
    """Ordered [(group, [(name, shape, kind, f32), ...])] of the model."""
    d, ffn, p = cfg["dim"], cfg["ffn_dim"], cfg["patch_size"]
    patch_in = cfg["in_dim"] * p[0] * p[1] * p[2]
    out = p[0] * p[1] * p[2] * cfg["out_dim"]

    def aff(name, d_in, d_out, f32=False):
        return [(f"{name}.w", (d_out, d_in), "w", f32),
                (f"{name}.b", (d_out,), "b", f32)]

    embed = (aff("patch_embedding", patch_in, d)
             + aff("text_embedding.fc1", cfg["text_dim"], d)
             + aff("text_embedding.fc2", d, d)
             + aff("time_embedding.fc1", cfg["freq_dim"], d, True)
             + aff("time_embedding.fc2", d, d, True)
             + aff("time_projection", d, 6 * d, True))
    groups = [("embed", embed)]
    for i in range(cfg["num_layers"]):
        blk = []
        for att in ("self_attn", "cross_attn"):
            for m in "qkvo":
                blk += aff(f"blocks.{i}.{att}.{m}", d, d)
            blk += [(f"blocks.{i}.{att}.norm_q", (d,), "ln", True),
                    (f"blocks.{i}.{att}.norm_k", (d,), "ln", True)]
        blk += [(f"blocks.{i}.norm3.w", (d,), "ln", True),
                (f"blocks.{i}.norm3.b", (d,), "b", True)]
        blk += aff(f"blocks.{i}.ffn.fc1", d, ffn)
        blk += aff(f"blocks.{i}.ffn.fc2", ffn, d)
        blk += [(f"blocks.{i}.modulation", (6, d), "mod", True)]
        groups.append((f"block.{i}", blk))
    groups.append(("head", aff("head_layer.linear", d, out)
                   + [("head_layer.modulation", (2, d), "mod", True)]))
    return groups


def _patchify(x, p):
    b, c, f, h, w = x.shape
    x = x.reshape(b, c, f // p[0], p[0], h // p[1], p[1], w // p[2], p[2])
    x = x.permute(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(b, -1, c * p[0] * p[1] * p[2])


def _unpatchify(x, grid, p, c):
    """Wan's per-token feature order is (pt, ph, pw, c)."""
    b = x.shape[0]
    gt, gh, gw = grid
    x = x.reshape(b, gt, gh, gw, p[0], p[1], p[2], c)
    x = x.permute(0, 7, 1, 4, 2, 5, 3, 6)
    return x.reshape(b, c, gt * p[0], gh * p[1], gw * p[2])


def _aff(w, name, x):
    return C.linear(x, w[name + ".w"], w[name + ".b"])


def _block(w, i, x, e6, ctx, plan, cfg, top_k, carved: bool):
    n, d = cfg["num_heads"], cfg["dim"]
    hd, eps = d // n, cfg["eps"]
    pre = f"blocks.{i}."
    e = w[pre + "modulation"].float()[None] + e6              # [B, 6, d]
    e0, e1, e2, e3, e4, e5 = (e[:, j:j + 1] for j in range(6))
    b, s, _ = x.shape

    y = C.layer_norm(x, eps=eps) * (1 + e1) + e0
    a = pre + "self_attn."
    q = C.rms_norm(_aff(w, a + "q", y), w[a + "norm_q"], eps)
    k = C.rms_norm(_aff(w, a + "k", y), w[a + "norm_k"], eps)
    v = _aff(w, a + "v", y).reshape(b, s, n, hd)
    q = C.rope(q.reshape(b, s, n, hd), plan["cos"], plan["sin"])
    k = C.rope(k.reshape(b, s, n, hd), plan["cos"], plan["sin"])
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if carved:
        nb = s // C.BLOCK
        sel = C.select_blocks(
            qt, kt, top_k=top_k, p_remain=plan["p_remain"], video_blocks=nb,
            neighbors=plan["neighbors"],
            first_frame_blocks=plan["first_frame_blocks"],
            group=plan["group"])
        o = C.sparse_attention(qt, kt, vt, sel, seqlen=plan["seqlen"],
                               group=plan["group"])
    else:
        # the dense fallback attends every token, the block padding too
        o = C.dense_attention(qt, kt, vt)
    del q, k, qt, kt, vt
    y = _aff(w, a + "o", o.transpose(1, 2).reshape(b, s, d))
    x = x + y * e2

    a = pre + "cross_attn."
    y = C.layer_norm(x, w[pre + "norm3.w"], w[pre + "norm3.b"], eps)
    q = C.rms_norm(_aff(w, a + "q", y), w[a + "norm_q"], eps)
    k = C.rms_norm(_aff(w, a + "k", ctx), w[a + "norm_k"], eps)
    v = _aff(w, a + "v", ctx)
    o = C.dense_attention(*(t.reshape(b, -1, n, hd).transpose(1, 2)
                            for t in (q, k, v)))
    x = x + _aff(w, a + "o", o.transpose(1, 2).reshape(b, s, d))

    y = C.layer_norm(x, eps=eps) * (1 + e4) + e3
    y = _aff(w, pre + "ffn.fc2", C.gelu_tanh(_aff(w, pre + "ffn.fc1", y)))
    return x + y * e5


def make_plan(cfg: dict, grid, curve_plan, *, p_remain: float, group: int):
    """The carving constants of a token grid: the curve order, its inverse,
    the block neighbours, the curve-ordered RoPE tables padded to whole
    blocks, the real token count and the first-frame blocks."""
    s = grid[0] * grid[1] * grid[2]
    s_pad = -(-s // C.BLOCK) * C.BLOCK
    hd = cfg["dim"] // cfg["num_heads"]
    c = hd // 2
    dims = (2 * (c - 2 * (c // 3)), 2 * (c // 3), 2 * (c // 3))
    cos, sin = C.rope_tables(grid, dims, 10000.0,
                             order=curve_plan.curve_order, pad_to=s_pad)
    return dict(order=torch.as_tensor(curve_plan.curve_order).long(),
                inverse=torch.as_tensor(curve_plan.linear_to_curve).long(),
                neighbors=torch.as_tensor(curve_plan.block_neighbors),
                cos=cos, sin=sin, seqlen=s, s_pad=s_pad,
                first_frame_blocks=(s_pad // C.BLOCK) // 21,
                p_remain=p_remain, group=group)


@torch.no_grad()
def velocity(weights, cfg: dict, x, t: float, context, plan, *,
             guide_scale: float, top_k: int, carved: bool, device):
    """The guided velocity [C, F, H, W] float32 of latents x [C, F, H, W]
    at timestep ``t``: the model on the batch (prompt, null prompt), then
    ``null + guide_scale * (prompt - null)``. ``weights(group)`` returns
    a group's tensors; ``context`` [2, text_len, text_dim] is the padded
    text states; ``plan`` from ``make_plan`` (on the CPU; moved here)."""
    plan = {k: (v.to(device) if torch.is_tensor(v) else v)
            for k, v in plan.items()}
    p, d = cfg["patch_size"], cfg["dim"]
    w = weights("embed")
    x2 = torch.stack([x, x]).float().to(device)
    grid = (x.shape[1] // p[0], x.shape[2] // p[1], x.shape[3] // p[2])
    h = _aff(w, "patch_embedding", _patchify(x2, p))
    tt = torch.full((2,), float(t), device=device)
    e = _aff(w, "time_embedding.fc2", torch.nn.functional.silu(
        _aff(w, "time_embedding.fc1", C.sinusoidal(cfg["freq_dim"], tt))))
    e6 = _aff(w, "time_projection", torch.nn.functional.silu(e)).reshape(
        2, 6, d)
    ctx = _aff(w, "text_embedding.fc2", C.gelu_tanh(
        _aff(w, "text_embedding.fc1", context.float().to(device))))
    del w
    h = h[:, plan["order"]]
    h = torch.nn.functional.pad(h, (0, 0, 0, plan["s_pad"] - h.shape[1]))
    for i in range(cfg["num_layers"]):
        h = _block(weights(f"block.{i}"), i, h, e6, ctx, plan, cfg, top_k,
                   carved)
    w = weights("head")
    h = h[:, plan["inverse"]]
    hm = w["head_layer.modulation"].float()[None] + e[:, None, :]
    y = C.layer_norm(h, eps=cfg["eps"]) * (1 + hm[:, 1:2]) + hm[:, 0:1]
    v2 = _unpatchify(_aff(w, "head_layer.linear", y), grid, p,
                     cfg["out_dim"])
    return v2[1] + guide_scale * (v2[0] - v2[1])


def top_k_of(step: int, steps: int, drop_rates, seqlen: int):
    """(carved, top_k) of a step under Jenga's warm-up: the drop rate
    ramps up over the first tenth of the steps, from the first rate; a
    rate of at most 0.25 runs dense."""
    base = drop_rates[0]
    drop = min(base, step / max(steps - 1, 1) * 10.0 * base)
    nb = math.ceil(seqlen / C.BLOCK)
    return drop > 0.25, max(int(nb * (1.0 - drop)), 1)
