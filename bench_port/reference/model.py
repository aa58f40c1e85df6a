"""The Prismatic VLA in plain fp32 PyTorch: towers, projector, decoder.

Written from the published descriptions, not from the port:

* ViT (DINOv2-L/14 with four registers and LayerScale; SigLIP-So400m/14):
  conv patch embedding, position embeddings (DINOv2: on the patches, class
  and register tokens in front), pre-norm blocks with bidirectional softmax
  attention and a GELU (SigLIP: tanh) MLP; the features are the patch tokens
  after the second-to-last block (the Prismatic tap). Both towers see the
  frame resized (bicubic, antialiased) to their size and normalized with
  their own mean and std; their features are concatenated per patch.
* Projector "fused-gelu-mlp": Linear -> GELU -> Linear -> GELU -> Linear.
* Decoder: Llama/Mistral (RMSNorm, rotary embedding, grouped-query
  attention with the sliding window, SwiGLU) or Phi-2 (one LayerNorm with
  bias, parallel residual x + attn + mlp, tanh-GELU MLP, rotary embedding
  over the first 40 % of each head, biases everywhere, final LayerNorm and a
  biased head). The image patches sit right after BOS.
* int8 serving (`quant="int8"`): every decoder projection quantized per
  output row (absmax * fp32(1/127), round half to even, clip at 127, the
  scale stored in bf16), the embedding and the head per row as well. Rows
  of the prompt (a prefill chunk of 8 or more tokens) quantize their
  activations per token (absmax / 127) and take the exact integer product
  (fp64 here); the decode rows multiply by the dequantized weight.
  `quant=None`: the float weights. `linear(...,
  lowp="int8")`, the LoRA cell's control one precision below bf16: a linear
  layer with int8 weights per output row and int8 activations per token
  (rounded and scaled back in fp32, the gradient straight through).

Everything runs in fp32 (int8 products in fp64) with TF32 off, one decoder
layer's weights upcast at a time, over a batch of teacher-forced sequences.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from reference.tokens import inference_prompt_ids

def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# --- preprocessing and towers --------------------------------------------------------


def preprocess(frames_u8: torch.Tensor, tower: Dict) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> [B, 3, size, size] fp32 for one tower."""
    img = frames_u8.permute(0, 3, 1, 2).float() / 255.0
    size = tower["image_size"]
    img = F.interpolate(img, size=(size, size), mode="bicubic", antialias=True, align_corners=False)
    mean = torch.tensor(tower["mean"], dtype=torch.float32, device=img.device)[:, None, None]
    std = torch.tensor(tower["std"], dtype=torch.float32, device=img.device)[:, None, None]
    return (img - mean) / std


def _gelu(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "gelu":
        return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))
    if act == "gelu_tanh":
        return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))
    raise ValueError(f"activation {act!r}")


def vit_features(w: Dict[str, torch.Tensor], tower: Dict, pixels: torch.Tensor, lowp: Optional[str] = None
                 ) -> torch.Tensor:
    """One tower's patch features after block depth - 2: [B, patches, width];
    `lowp` "int8" runs its linear layers w8a8."""
    f = lambda name: w[name].float()  # noqa: E731
    width, heads = tower["width"], tower["num_heads"]
    hd = width // heads
    x = F.conv2d(pixels, f("patch_embed.weight"), f("patch_embed.bias"), stride=tower["patch_size"])
    b = x.shape[0]
    x = x.flatten(2).transpose(1, 2)
    prefix = []
    if tower.get("use_cls_token", True):
        prefix.append(f("cls_token").expand(b, 1, width))
    if tower.get("num_reg_tokens", 0):
        prefix.append(f("reg_tokens").expand(b, tower["num_reg_tokens"], width))
    if tower.get("no_embed_class", False):
        x = torch.cat(prefix + [x + f("pos_embed")], dim=1)
    else:
        x = torch.cat(prefix + [x], dim=1) + f("pos_embed")
    eps = tower["ln_eps"]
    if tower.get("pre_norm", False):
        x = F.layer_norm(x, (width,), f("norm_pre.weight"), f("norm_pre.bias"), eps)
    t = x.shape[1]
    for i in range(tower["depth"] - 1):
        p = f"blocks.{i}."
        y = F.layer_norm(x, (width,), f(p + "norm1.weight"), f(p + "norm1.bias"), eps)
        qkv = (linear(y, f(p + "qkv.weight"), lowp) + f(p + "qkv.bias")).view(b, t, 3, heads, hd)
        q, k, v = qkv.unbind(dim=2)
        scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(hd)
        attn = torch.einsum("bhts,bshd->bthd", scores.softmax(dim=-1), v).reshape(b, t, width)
        y = linear(attn, f(p + "proj.weight"), lowp) + f(p + "proj.bias")
        if tower.get("layerscale_init") is not None:
            y = y * f(p + "ls1")
        x = x + y
        y = F.layer_norm(x, (width,), f(p + "norm2.weight"), f(p + "norm2.bias"), eps)
        y = _gelu(linear(y, f(p + "mlp_fc1.weight"), lowp) + f(p + "mlp_fc1.bias"), tower["act"])
        y = linear(y, f(p + "mlp_fc2.weight"), lowp) + f(p + "mlp_fc2.bias")
        if tower.get("layerscale_init") is not None:
            y = y * f(p + "ls2")
        x = x + y
    n_prefix = (1 if tower.get("use_cls_token", True) else 0) + tower.get("num_reg_tokens", 0)
    return x[:, n_prefix:]


def vision_embeddings(params: Dict, cfg: Dict, frames_u8: torch.Tensor, lowp: Optional[str] = None) -> torch.Tensor:
    """Frames -> projected patch embeddings [B, patches, dim] (fp32; `lowp`
    "int8": every linear layer w8a8)."""
    towers = cfg["port"]["towers"]
    prefixes = ("featurizer.", "fused_featurizer.") if len(towers) == 2 else ("",)
    feats = []
    for prefix, tower in zip(prefixes, towers):
        w = {k[len(prefix):]: v for k, v in params["vision"].items() if k.startswith(prefix)}
        feats.append(vit_features(w, tower, preprocess(frames_u8, tower), lowp))
    h = torch.cat(feats, dim=2)
    pr = {k: v.float() for k, v in params["projector"].items()}
    h = _gelu(linear(h, pr["fc1.weight"], lowp) + pr["fc1.bias"], "gelu")
    h = _gelu(linear(h, pr["fc2.weight"], lowp) + pr["fc2.bias"], "gelu")
    return linear(h, pr["fc3.weight"], lowp) + pr["fc3.bias"]


# --- weight quantization -----------------------------------------------------------


def quantize_rows(w: torch.Tensor, reciprocal: bool) -> Dict[str, torch.Tensor]:
    """Per output row int8: codes, the fp32 scale the codes were rounded
    with, and the stored bf16 scale."""
    w32 = w.float()
    absmax = w32.abs().amax(dim=1, keepdim=True)
    if reciprocal:
        scale = absmax * torch.tensor(1.0 / 127.0, dtype=torch.float32, device=w.device)
    else:
        scale = absmax / torch.tensor(127.0, dtype=torch.float32, device=w.device)
    scale = torch.where(absmax == 0, torch.ones_like(scale), scale)
    codes = torch.clamp(torch.round(w32 / scale), -127, 127)
    return {"codes": codes, "scale": scale.to(torch.bfloat16).float()}


def quantize_tokens(x: torch.Tensor):
    """Per-token int8 codes (fp64) and the fp32 token scale."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax / torch.full_like(absmax, 127.0))
    return torch.round(x / scale).double(), scale


def fake_quant_tokens(x: torch.Tensor) -> torch.Tensor:
    """x with each token's row rounded to int8 codes (absmax / 127) and back;
    the gradient passes straight through."""
    absmax = x.detach().abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax / 127.0)
    return x + (torch.round(x.detach() / scale) * scale - x.detach())


def fake_quant_rows(w: torch.Tensor) -> torch.Tensor:
    q = quantize_rows(w, reciprocal=True)
    return q["codes"] * q["scale"]


def linear(x: torch.Tensor, w: torch.Tensor, lowp: Optional[str]) -> torch.Tensor:
    """x @ w^T, or with `lowp` "int8" the w8a8 product: the weight per
    output row and the activations per token rounded to int8."""
    if lowp is None:
        return x @ w.T
    if lowp != "int8":
        raise ValueError(f"lower precision {lowp!r}")
    return fake_quant_tokens(x) @ fake_quant_rows(w).T


class Projection:
    """One decoder projection as the configuration serves it."""

    def __init__(self, w: torch.Tensor, quant: Optional[str]):
        self.quant = quant
        if quant == "int8":
            q = quantize_rows(w, reciprocal=True)
            self.codes, self.scale = q["codes"], q["scale"]
            self.dense = q["codes"] * q["scale"]
        else:
            self.dense = w.float()

    def __call__(self, x: torch.Tensor, prefill_rows: torch.Tensor) -> torch.Tensor:
        """x [N, in] fp32; `prefill_rows` [N] bool: rows of a prefill chunk
        (w8a8 for int8)."""
        y = x @ self.dense.T
        if self.quant == "int8" and bool(prefill_rows.any()):
            rows = prefill_rows.nonzero()[:, 0]
            q, s = quantize_tokens(x[rows])
            acc = (q @ self.codes.double().T).float()
            y[rows] = acc * s * self.scale[:, 0]
        return y


# --- decoder --------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, rotary_dim: int, theta: float) -> torch.Tensor:
    """Rotate-half rotary embedding over the first `rotary_dim` dims of each
    head. x [N, H, hd], positions [N]."""
    inv = 1.0 / (theta ** (torch.arange(0, rotary_dim, 2, dtype=torch.float32, device=x.device) / rotary_dim))
    ang = positions.float()[:, None] * inv
    cos, sin = torch.cat([ang, ang], dim=-1).cos()[:, None], torch.cat([ang, ang], dim=-1).sin()[:, None]
    xr, xp = x[..., :rotary_dim], x[..., rotary_dim:]
    half = rotary_dim // 2
    rotated = torch.cat([-xr[..., half:], xr[..., :half]], dim=-1)
    return torch.cat([xr * cos + rotated * sin, xp], dim=-1)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * w


def decoder_logits(params: Dict, cfg: Dict, embeds: List[torch.Tensor], prefill_len: Sequence[int],
                   out_rows: Sequence[Sequence[int]], quant: Optional[str]) -> List[torch.Tensor]:
    """Each sequence's fp32 input embeddings [n_i, D] through the decoder
    (causal, positions 0..n_i-1); rows < prefill_len[i] form the prefill
    chunk. Returns the logits [len(out_rows[i]), V] at the asked rows."""
    llm = cfg["port"]["llm"]
    lw = params["llm"]
    d, h, hkv = llm["dim"], llm["n_heads"], llm["n_kv_heads"]
    hd = d // h
    rd = int(llm["rotary_pct"] * hd)
    eps, phi, window = llm["norm_eps"], llm["arch"] == "phi", llm.get("sliding_window")
    dev = embeds[0].device
    lens = [e.shape[0] for e in embeds]
    x = torch.cat(embeds, dim=0)
    pos = torch.cat([torch.arange(n, device=dev) for n in lens])
    prefill = torch.cat([torch.arange(n, device=dev) < p for n, p in zip(lens, prefill_len)])
    starts = np.cumsum([0] + lens)
    for lp in lw["layers"]:
        f = {k: v.float() for k, v in lp.items()}
        proj = {k: Projection(lp[k], quant) for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down") if k in lp}
        if phi:
            hin = F.layer_norm(x, (d,), f["attn_norm"], f["attn_norm_bias"], eps)
        else:
            hin = rms_norm(x, f["attn_norm"], eps)
        q, k, v = (proj[n](hin, prefill) for n in ("wq", "wk", "wv"))
        if phi:
            q, k, v = q + f["bq"], k + f["bk"], v + f["bv"]
        q = rope(q.view(-1, h, hd), pos, rd, llm["rope_theta"])
        k = rope(k.view(-1, hkv, hd), pos, rd, llm["rope_theta"])
        v = v.view(-1, hkv, hd)
        attn = torch.empty_like(q)
        for i, n in enumerate(lens):
            a, b = starts[i], starts[i + 1]
            kk = k[a:b].repeat_interleave(h // hkv, dim=1)
            vv = v[a:b].repeat_interleave(h // hkv, dim=1)
            scores = torch.einsum("thd,shd->hts", q[a:b], kk) / math.sqrt(hd)
            r = torch.arange(n, device=dev)
            ok = r[None, :] <= r[:, None]
            if window is not None:
                ok = ok & (r[None, :] > r[:, None] - window)
            scores = scores.masked_fill(~ok, float("-inf"))
            attn[a:b] = torch.einsum("hts,shd->thd", scores.softmax(dim=-1), vv)
        o = proj["wo"](attn.reshape(-1, h * hd), prefill)
        if phi:
            o = o + f["bo"]
            up = _gelu(proj["w_up"](hin, prefill) + f["b_up"], "gelu_tanh")
            x = x + o + proj["w_down"](up, prefill) + f["b_down"]
        else:
            x = x + o
            h2 = rms_norm(x, f["mlp_norm"], eps)
            g, u = proj["w_gate"](h2, prefill), proj["w_up"](h2, prefill)
            x = x + proj["w_down"](g * torch.sigmoid(g) * u, prefill)
    if phi:
        x = F.layer_norm(x, (d,), lw["final_norm"].float(), lw["final_norm_bias"].float(), eps)
    else:
        x = rms_norm(x, lw["final_norm"].float(), eps)
    rows = torch.cat([torch.as_tensor(list(r), device=dev) + int(starts[i]) for i, r in enumerate(out_rows)])
    head = lm_head(lw, quant)
    logits = x[rows] @ head.T
    if phi:
        logits = logits + lw["lm_head_bias"].float()
    out, at = [], 0
    for r in out_rows:
        out.append(logits[at:at + len(r)])
        at += len(r)
    return out


def lm_head(lw: Dict, quant: Optional[str]) -> torch.Tensor:
    if quant == "int8":
        q = quantize_rows(lw["lm_head"], reciprocal=False)
        return q["codes"] * q["scale"]
    return lw["lm_head"].float()


def token_embeddings(lw: Dict, ids: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    if quant == "int8":
        rows = quantize_rows(lw["embed"][ids], reciprocal=False)
        return rows["codes"] * rows["scale"]
    return lw["embed"][ids].float()


def served_logits(params: Dict, cfg: Dict, frames_u8: torch.Tensor, instructions: Sequence[str],
                  tokens: np.ndarray, quant: Optional[str]) -> List[torch.Tensor]:
    """Teacher-forced logits [n_tokens, V] of each request: the prefill's
    last real row and one row per served token fed back, over
    [BOS | patches | prompt | served tokens[:-1]]."""
    llm_family = cfg["port"]["llm_family"]
    lw = params["llm"]
    dev = frames_u8.device
    patches = vision_embeddings(params, cfg, frames_u8)
    embeds, prefill_len, out_rows = [], [], []
    for i, text in enumerate(instructions):
        prompt = torch.as_tensor(inference_prompt_ids(text, llm_family), device=dev)
        fed = torch.as_tensor(np.asarray(tokens[i][:-1], np.int64), device=dev)
        ids = torch.cat([prompt, fed])
        te = token_embeddings(lw, ids, quant)
        seq = torch.cat([te[:1], patches[i], te[1:]], dim=0)
        n_prompt = len(prompt) + patches.shape[1]
        embeds.append(seq)
        prefill_len.append(n_prompt)
        out_rows.append(range(n_prompt - 1, n_prompt - 1 + len(tokens[i])))
    return decoder_logits(params, cfg, embeds, prefill_len, out_rows, quant)
