"""Plain PyTorch reference of the IDEE model: encoder (Mamba or Swin_3D),
the 1-bit lookup-free quantizer, the CNN_3D classifier and the synthetic
training loss, in float32, written as functions over a dict of named
parameters.

The parameter names and shapes are those of the port's ``VQModel``
(per-variable weights stacked on axis 0), so the benchmark hands the same
tensors to both sides. Nothing here imports the port: the windowed scan
is a loop over the window's tokens, the window attention two products
around a softmax, the convolutions ``F.conv3d``.

``Precision`` rounds the activations a lower-precision model keeps (the
inputs and outputs of every product, the norms' and activations' outputs,
the residual stream, the classifier's input) for the lower-precision
control: "float32" and "tf32" leave them
as they are (TF32 is a switch of the card's libraries, set by the
caller), "fp8" rounds each to float8 e4m3 with a per-tensor scale and
its gradient to float8 e5m2.
"""

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

# the largest finite values of float8 e4m3 (activations) and e5m2
# (gradients)
FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def round_fp8(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` with a per-tensor scale, back in
    float32."""
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX[dtype]
    return (t / scale).to(dtype).float() * scale


class _Fp8(torch.autograd.Function):
    """Forward rounded to e4m3, the gradient rounded to e5m2: what a
    float8 training recipe keeps of each."""

    @staticmethod
    def forward(ctx, t):
        return round_fp8(t, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g, torch.float8_e5m2)


class Precision:
    """Rounding applied to every activation the model keeps."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "tf32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.name != "fp8":
            return t
        return _Fp8.apply(t)


# ---------------------------------------------------------------- layers

def dense(x, kernel, bias, prec: Precision):
    """Per-variable dense layer: x [..., V*in], kernel [V, in, out], bias
    [V, out] or None -> [..., V*out]."""
    V, fin, fout = kernel.shape
    lead = x.shape[:-1]
    y = torch.einsum("...vi,vio->...vo", prec(x.reshape(*lead, V, fin)),
                     prec(kernel)).reshape(*lead, V * fout)
    if bias is not None:
        y = y + bias.reshape(V * fout)
    return prec(y)


def group_norm(x, V: int, eps: float = 1e-5):
    """LayerNorm without affine over each variable's channels of
    [..., V*C]."""
    lead = x.shape[:-1]
    xv = x.reshape(*lead, V, -1)
    mu = xv.mean(-1, keepdim=True)
    var = ((xv - mu) ** 2).mean(-1, keepdim=True)
    return ((xv - mu) / torch.sqrt(var + eps)).reshape(x.shape)


def grouped_conv(x, kernel, bias, prec: Precision, stride=(1, 1, 1),
                 pad=((0, 0), (0, 0), (0, 0)), mode: str = "constant"):
    """Per-variable 3D convolution on channels-last [N, D, H, W, V*Cin];
    kernel [V, kd, kh, kw, Cin, Cout], bias [V, Cout] or None."""
    V, kd, kh, kw, cin, cout = kernel.shape
    xc = x.permute(0, 4, 1, 2, 3)
    flat = [p for lo_hi in reversed(pad) for p in lo_hi]
    if any(flat):
        xc = F.pad(xc, flat, mode=mode)
    w = kernel.permute(0, 5, 4, 1, 2, 3).reshape(V * cout, cin, kd, kh, kw)
    b = None if bias is None else bias.reshape(V * cout)
    y = F.conv3d(prec(xc), prec(w), b, stride=stride, groups=V)
    return prec(y.permute(0, 2, 3, 4, 1))


def conv(x, weight, bias, prec: Precision, stride, pad):
    """Plain 3D convolution on channels-last [N, D, H, W, Cin]; weight
    [Cout, Cin, kd, kh, kw]."""
    xc = x.permute(0, 4, 1, 2, 3)
    flat = [p for lo_hi in reversed(pad) for p in lo_hi]
    xc = F.pad(xc, flat)
    y = F.conv3d(prec(xc), prec(weight), bias, stride=stride)
    return prec(y.permute(0, 2, 3, 4, 1))


# ---------------------------------------------------------------- windows

def shrink_window(size, window, shift):
    """The window and shift cut to an input no larger than a window."""
    ws, ss = list(window), list(shift)
    for i, s in enumerate(size):
        if s <= window[i]:
            ws[i], ss[i] = s, 0
    return tuple(ws), tuple(ss)


def partition(x, ws):
    """[B, D, H, W, C] -> [B*nW, wd*wh*ww, C]."""
    B, D, H, W, C = x.shape
    x = x.reshape(B, D // ws[0], ws[0], H // ws[1], ws[1], W // ws[2],
                  ws[2], C)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, math.prod(ws), C)


def unpartition(win, ws, B, D, H, W):
    x = win.reshape(B, D // ws[0], H // ws[1], W // ws[2], ws[0], ws[1],
                    ws[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, D, H, W, -1)


def shift_mask(Dp, Hp, Wp, ws, ss, device):
    """[nW, n, n] additive mask (0 / -100) of the shifted windows: tokens
    from different regions of the rolled grid do not attend to each
    other."""
    img = torch.zeros((1, Dp, Hp, Wp, 1), device=device)
    cnt = 0
    regions = [((slice(0, -w), slice(-w, -s), slice(-s, None)) if s
                else (slice(None),)) for w, s in zip(ws, ss)]
    for d in regions[0]:
        for h in regions[1]:
            for w in regions[2]:
                img[:, d, h, w, :] = cnt
                cnt += 1
    lab = partition(img, ws)[..., 0]                       # [nW, n]
    diff = lab[:, None, :] - lab[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


def relative_index(ws, device):
    """[n, n] index of each token pair's relative offset in the bias
    table."""
    coords = torch.stack(torch.meshgrid(
        *(torch.arange(w) for w in ws), indexing="ij")).reshape(3, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + torch.tensor([w - 1 for w in ws])
    mult = torch.tensor([(2 * ws[1] - 1) * (2 * ws[2] - 1),
                         2 * ws[2] - 1, 1])
    return (rel * mult).sum(-1).to(device)


def windowed(x, window, shift, fn):
    """x [B, D, H, W, C] through ``fn(windows, mask)`` over (shifted)
    windows padded to multiples, back to x's shape."""
    B, D, H, W, _ = x.shape
    ws, ss = shrink_window((D, H, W), window, shift)
    pad = [(w - s % w) % w for w, s in zip(ws, (D, H, W))]
    y = F.pad(x, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0])) if any(pad) else x
    _, Dp, Hp, Wp, _ = y.shape
    shifted = any(s > 0 for s in ss)
    mask = None
    if shifted:
        y = torch.roll(y, shifts=tuple(-s for s in ss), dims=(1, 2, 3))
        mask = shift_mask(Dp, Hp, Wp, ws, ss, x.device)
    y = unpartition(fn(partition(y, ws), ws, mask), ws, B, Dp, Hp, Wp)
    if shifted:
        y = torch.roll(y, shifts=ss, dims=(1, 2, 3))
    return y[:, :D, :H, :W]


# ---------------------------------------------------------------- encoders

def mamba_ssm(P: Params, pre: str, x, V: int, d_state: int, prec):
    """Mamba v1 block over window tokens x [B_, L, V*d_model]: in_proj,
    causal depthwise conv, silu, x_proj, softplus(dt_proj), selective scan
    with A = -exp(A_log), skip D, silu(z) gating, out_proj."""
    B_, L, _ = x.shape
    k_conv = P[pre + "conv1d_kernel"]                     # [V, k, 1, d]
    d_inner, n = k_conv.shape[-1], d_state
    dt_rank = P[pre + "dt_proj.kernel"].shape[1]
    xz = dense(x, P[pre + "in_proj.kernel"], None, prec).reshape(
        B_, L, V, 2, d_inner)
    u, z = xz[:, :, :, 0], xz[:, :, :, 1]                 # [B_, L, V, d]
    k = k_conv.shape[1]
    w = k_conv.permute(0, 3, 2, 1).reshape(V * d_inner, 1, k)
    uc = F.pad(u.reshape(B_, L, V * d_inner).transpose(1, 2), (k - 1, 0))
    uc = F.conv1d(uc, w, P[pre + "conv1d_bias"].reshape(-1),
                  groups=V * d_inner)
    u = F.silu(uc.transpose(1, 2)).reshape(B_, L, V, d_inner)
    x_dbl = dense(u.reshape(B_, L, V * d_inner), P[pre + "x_proj.kernel"],
                  None, prec).reshape(B_, L, V, dt_rank + 2 * n)
    dt = x_dbl[..., :dt_rank].reshape(B_, L, V * dt_rank)
    Bs, Cs = x_dbl[..., dt_rank:dt_rank + n], x_dbl[..., dt_rank + n:]
    delta = F.softplus(dense(dt, P[pre + "dt_proj.kernel"],
                             P[pre + "dt_proj.bias"], prec))
    delta = delta.reshape(B_, L, V, d_inner)
    A = -torch.exp(P[pre + "A_log"])                      # [V, d, n]
    D = P[pre + "D"]                                      # [V, d]
    h = torch.zeros((B_, V, d_inner, n), device=x.device)
    ys = []
    for t in range(L):
        dl = delta[:, t, :, :, None]
        h = torch.exp(dl * A) * h + dl * u[:, t, :, :, None] \
            * Bs[:, t, :, None, :]
        ys.append((h * Cs[:, t, :, None, :]).sum(-1) + D * u[:, t])
    y = torch.stack(ys, 1) * F.silu(z)
    return dense(y.reshape(B_, L, V * d_inner), P[pre + "out_proj.kernel"],
                 None, prec)


def window_attention(P: Params, pre: str, win, ws, mask, V: int, heads: int,
                     prec, chunk: int = 16384):
    """Multi-head window attention with relative position bias over
    windows [B_, n, V*C], the V variables' heads side by side."""
    B_, n, VC = win.shape
    hd = VC // V // heads
    G = V * heads
    qkv = dense(win, P[pre + "qkv.kernel"], P[pre + "qkv.bias"], prec)
    qkv = qkv.reshape(B_, n, V, 3, heads, hd)
    q, k, v = (qkv[:, :, :, i].reshape(B_, n, G, hd).transpose(1, 2)
               for i in range(3))                         # [B_, G, n, hd]
    table = P[pre + "relative_position_bias_table"]       # [V, T, heads]
    bias = table[:, relative_index(ws, win.device).reshape(-1)]
    bias = bias.reshape(V, n, n, heads).permute(0, 3, 1, 2).reshape(G, n, n)
    scale = hd ** -0.5
    outs = []
    step = B_ if torch.is_grad_enabled() else chunk
    for a in range(0, B_, step):
        b = min(a + step, B_)
        s = prec(q[a:b]) @ prec(k[a:b]).transpose(-1, -2) * scale + bias
        if mask is not None:
            nW = mask.shape[0]
            idx = torch.arange(a, b, device=win.device) % nW
            s = s + mask[idx][:, None]
        p = torch.softmax(prec(s), dim=-1)
        outs.append(prec(prec(p) @ prec(v[a:b])))
    out = torch.cat(outs).transpose(1, 2).reshape(B_, n, VC)
    return dense(out, P[pre + "proj.kernel"], P[pre + "proj.bias"], prec)


def encoder(P: Params, cfg: dict, x, prec):
    """[N, V, C, T, H, W] -> packed [N, T, H, W, V*E]."""
    N, V, C, T, H, W = x.shape
    x = x.permute(0, 3, 4, 5, 1, 2).reshape(N, T, H, W, V * C)
    dims = cfg["en_embed_dim"]
    in_dim = C
    for i, dim in enumerate(dims):
        pre = f"encoder.stage{i}."
        patch = tuple(cfg["en_patch_size"]) if i == 0 else (1, 1, 1)
        if in_dim != dim or patch != (1, 1, 1):
            sizes = x.shape[1:4]
            hi = [(p - s % p) % p for p, s in zip(patch, sizes)]
            if any(hi):
                x = F.pad(x, (0, 0, 0, hi[2], 0, hi[1], 0, hi[0]))
            x = grouped_conv(x, P[pre + "downsample.proj.kernel"],
                             P[pre + "downsample.proj.bias"], prec,
                             stride=patch)
            x = prec(group_norm(x, V))
        in_dim = dim
        window = tuple(cfg["en_window_size"][i])
        for j in range(cfg["en_depths"][i]):
            bp = pre + f"block{j}."
            shift = (0, 0, 0) if j % 2 == 0 else tuple(w // 2 for w in window)
            if cfg["encoder"] == "Mamba":
                def fn(win, ws, mask, bp=bp, i=i):
                    return mamba_ssm(P, bp + "ssm.", win, V,
                                     cfg["d_state"][i], prec)
            else:
                def fn(win, ws, mask, bp=bp, i=i):
                    return window_attention(P, bp + "attn.", win, ws, mask,
                                            V, cfg["en_n_heads"][i], prec)
            x = prec(x + windowed(prec(group_norm(x, V)), window, shift,
                                  fn))
            z = prec(F.gelu(dense(prec(group_norm(x, V)),
                                  P[bp + "mlp_fc1.kernel"],
                                  P[bp + "mlp_fc1.bias"], prec)))
            x = prec(x + dense(z, P[bp + "mlp_fc2.kernel"],
                               P[bp + "mlp_fc2.bias"], prec))
    rep = ((1, 1), (1, 1), (1, 1))
    x = F.relu(grouped_conv(x, P["encoder.proj.proj1.kernel"],
                            P["encoder.proj.proj1.bias"], prec, pad=rep,
                            mode="replicate"))
    return grouped_conv(x, P["encoder.proj.proj2.kernel"],
                        P["encoder.proj.proj2.bias"], prec, pad=rep,
                        mode="replicate")


# ---------------------------------------------------------------- quantizer

class Quantized(NamedTuple):
    s_q: torch.Tensor        # [N, T, H, W, V], +-1
    bits: torch.Tensor       # [N, V, T, H, W] int, the anomaly bits
    aux: torch.Tensor        # scalar


def lfq(P: Params, cfg: dict, zp, V: int, train: bool) -> Quantized:
    """1-bit lookup-free quantization of each variable's feature: project
    to one scalar, keep its sign (straight through in training), and in
    training the commitment and entropy terms over the 2-code codebook."""
    lead = zp.shape[:-1]
    feats = zp.reshape(*lead, V, -1)
    s = (feats @ P["vq.project_in.weight"].t() + P["vq.project_in.bias"]
         )[..., 0]                                        # [N, T, H, W, V]
    q = torch.where(s > 0, 1.0, -1.0)
    s_q = q + (s - s.detach()) if train else q
    bits = (q > 0).long().permute(0, 4, 1, 2, 3)
    if not train:
        return Quantized(s_q, bits, torch.zeros((), device=zp.device))
    codes = torch.tensor([-1.0, 1.0], device=zp.device)
    logits = 2.0 * s[..., None] * codes * cfg["codebook_inv_temperature"]
    prob = torch.softmax(logits, -1).reshape(-1, 2)

    def entropy(p):
        return (-p * torch.log(p.clamp(min=1e-5))).sum(-1)

    aux = (cfg["lambda_commitment"] * ((s - q) ** 2).mean()
           + cfg["lambda_entropy"] * entropy(prob).mean()
           - cfg["diversity_gamma"] * entropy(prob.mean(0)))
    return Quantized(s_q, bits, aux)


# ---------------------------------------------------------------- classifier

_K, _S, _PAD = (2, 3, 3), (2, 1, 1), ((0, 0), (1, 1), (1, 1))


def classifier(P: Params, zq, prec):
    """Joint head over all variables' codes and one head per variable:
    zq [N, T, H, W, V*C] -> z [N, 1, H, W], y [N, V, 1, H, W]."""
    y = zq
    for i in (1, 2, 3):
        y = grouped_conv(y, P[f"cls.heads_var.conv{i}.kernel"],
                         P[f"cls.heads_var.conv{i}.bias"], prec, _S, _PAD)
        y = F.relu(y) if i < 3 else y
    z = zq
    for i in (1, 2, 3):
        z = conv(z, P[f"cls.head_joint.conv{i}.weight"],
                 P[f"cls.head_joint.conv{i}.bias"], prec, _S, _PAD)
        z = F.relu(z) if i < 3 else z
    return z[:, 0].permute(0, 3, 1, 2), y[:, 0].permute(0, 3, 1, 2)[:, :, None]


# ---------------------------------------------------------------- model, loss

class Output(NamedTuple):
    z: torch.Tensor
    y: torch.Tensor
    bits: torch.Tensor
    loss_z_q: torch.Tensor
    loss_anomaly: torch.Tensor


def forward(P: Params, cfg: dict, x, mask_extreme_loss, train: bool,
            prec: Optional[Precision] = None) -> Output:
    """x [N, V, 1, T, H, W] (index 0 of T the target week)."""
    prec = prec or Precision()
    V = x.shape[1]
    zp = encoder(P, cfg, x, prec)
    qt = lfq(P, cfg, zp, V, train)
    w_out = P["vq.project_out.weight"][:, 0]
    b_out = P["vq.project_out.bias"]
    zq = qt.s_q[..., None] * w_out + b_out               # [N, T, H, W, V, C]
    z, y = classifier(P, prec(zq.reshape(*zq.shape[:4], -1)), prec)
    # the L1 to the normal code project_out(-1) outside extreme pixels
    vq0 = ((-1.0) * w_out + b_out).detach()
    wpix = 1.0 - mask_extreme_loss.clamp(0.0, 1.0)        # [N, H, W]
    wfull = wpix[:, None, :, :, None, None].expand(zq.shape)
    l1 = ((zq - vq0).abs() * wfull).sum() / wfull.sum()
    return Output(z, y, qt.bits, qt.aux, l1)


def bce(logits, target, hist):
    """Inverse-frequency weighted BCE on logits, mean-reduced."""
    frac = hist / hist.sum().clamp(min=1.0)
    w = torch.where(frac > 0, torch.log(frac.clamp(min=1e-30) ** -0.5 + 1.1),
                    torch.zeros_like(frac))
    weights = w[target.long()]
    el = logits.clamp(min=0.0) - logits * target \
        + torch.log1p(torch.exp(-logits.abs()))
    return (el * weights).mean()


def total_loss(out: Output, mask_extreme, lambda_anomaly: float):
    """BCE(joint) + lambda * anomaly L1 + sum_v BCE(head v) + quantizer
    aux; returns the components by the port's names."""
    target = mask_extreme.float()[:, None]
    hist = torch.stack([(target == 0).sum(), (target == 1).sum()]).float()
    loss_bce = bce(out.z, target, hist)
    loss_var = sum(bce(out.y[:, v], target, hist)
                   for v in range(out.y.shape[1]))
    loss = loss_bce + lambda_anomaly * out.loss_anomaly + loss_var \
        + out.loss_z_q
    return {"loss": loss, "loss_bce": loss_bce,
            "loss_anomaly": out.loss_anomaly, "loss_var": loss_var,
            "loss_z_q": out.loss_z_q}


def param_shapes(cfg: dict, in_channels: int) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's name and shape for ``cfg`` (window tables at the
    configured windows: ``shapes_for_input`` shrinks them)."""
    V = cfg["in_channels_dynamic"]
    dims = cfg["en_embed_dim"]
    out: Dict[str, Tuple[int, ...]] = {}
    in_dim = in_channels
    for i, dim in enumerate(dims):
        pre = f"encoder.stage{i}."
        patch = tuple(cfg["en_patch_size"]) if i == 0 else (1, 1, 1)
        if in_dim != dim or patch != (1, 1, 1):
            out[pre + "downsample.proj.kernel"] = (V, *patch, in_dim, dim)
            out[pre + "downsample.proj.bias"] = (V, dim)
        in_dim = dim
        for j in range(cfg["en_depths"][i]):
            bp = pre + f"block{j}."
            if cfg["encoder"] == "Mamba":
                d = cfg["expand"][i] * dim
                n = cfg["d_state"][i]
                r = math.ceil(dim / 16)
                s = bp + "ssm."
                out.update({
                    s + "in_proj.kernel": (V, dim, 2 * d),
                    s + "conv1d_kernel": (V, cfg["d_conv"][i], 1, d),
                    s + "conv1d_bias": (V, d),
                    s + "x_proj.kernel": (V, d, r + 2 * n),
                    s + "dt_proj.kernel": (V, r, d),
                    s + "dt_proj.bias": (V, d),
                    s + "A_log": (V, d, n),
                    s + "D": (V, d),
                    s + "out_proj.kernel": (V, d, dim)})
            else:
                h = cfg["en_n_heads"][i]
                ws = cfg["en_window_size"][i]
                a = bp + "attn."
                out.update({
                    a + "relative_position_bias_table": (
                        V, math.prod(2 * w - 1 for w in ws), h),
                    a + "qkv.kernel": (V, dim, 3 * dim),
                    a + "qkv.bias": (V, 3 * dim),
                    a + "proj.kernel": (V, dim, dim),
                    a + "proj.bias": (V, dim)})
            hid = int(dim * cfg["en_mlp_ratio"])
            out.update({bp + "mlp_fc1.kernel": (V, dim, hid),
                        bp + "mlp_fc1.bias": (V, hid),
                        bp + "mlp_fc2.kernel": (V, hid, dim),
                        bp + "mlp_fc2.bias": (V, dim)})
    E, C, cd = dims[-1], cfg["codebook_dim"], cfg["cls_dim"]
    for k in (1, 2):
        out[f"encoder.proj.proj{k}.kernel"] = (V, 3, 3, 3, E, E)
        out[f"encoder.proj.proj{k}.bias"] = (V, E)
    for k, (i, o) in enumerate(((C, cd), (cd, cd), (cd, 1)), 1):
        out[f"cls.heads_var.conv{k}.kernel"] = (V, *_K, i, o)
        out[f"cls.heads_var.conv{k}.bias"] = (V, o)
    for k, (i, o) in enumerate(((V * C, V * cd), (V * cd, V * cd),
                                (V * cd, 1)), 1):
        out[f"cls.head_joint.conv{k}.weight"] = (o, i, *_K)
        out[f"cls.head_joint.conv{k}.bias"] = (o,)
    out.update({"vq.project_in.weight": (1, C), "vq.project_in.bias": (1,),
                "vq.project_out.weight": (C, 1), "vq.project_out.bias": (C,)})
    return out


def shapes_for_input(cfg: dict, in_channels: int,
                     size: Sequence[int]) -> Dict[str, Tuple[int, ...]]:
    """``param_shapes`` with each attention's bias table at the window
    shrunk to the input (T, H, W) of the stage."""
    shapes = param_shapes(cfg, in_channels)
    if cfg["encoder"] != "Mamba":
        for i, window in enumerate(cfg["en_window_size"]):
            ws, _ = shrink_window(tuple(size), window, (0, 0, 0))
            for j in range(cfg["en_depths"][i]):
                key = (f"encoder.stage{i}.block{j}.attn."
                       "relative_position_bias_table")
                V, _, h = shapes[key]
                shapes[key] = (V, math.prod(2 * w - 1 for w in ws), h)
    return shapes
