"""The LoRA fine-tuning step in plain fp32 PyTorch.

Re-derived from the LoRA paper and the optax rules the port states, not
from the port's code:

* adapters on every decoder projection: y = x W^T + (x A^T) B^T, A drawn
  N(0, 1/r) * alpha / r from the run's LoRA generator in layer order and
  projection order (q, k, v, o, gate, up, down; Phi-2 has no gate), B zero;
* the batch's fused sequence [BOS | patches | prompt, actions, EOS], right
  padded; causal attention over the example's valid keys; the loss is the
  mean next-token cross entropy over the labelled positions (the seven
  action ids and EOS), over the padded vocabulary;
* towers, projector, embedding and base weights frozen;
* clip by the global norm (fp64 sum of squares) at `max_norm` when the norm
  is at least `max_norm`, then AdamW (b1, b2, eps 1e-8, no decay) with
  bias correction at the 1-based step, at a constant learning rate.

Runs in blocks of rows (the gradients of each block's share of the loss
summed), so that fp32 activations fit beside the fp32 weights.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from reference.model import _gelu, linear, rms_norm, rope, vision_embeddings

ALL_LINEAR = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
IGNORE = -100


def lora_init(layers: Sequence[Dict], rank: int, alpha: float, seed: int, device) -> Dict[str, torch.Tensor]:
    """{"<layer>.<proj>_lora_a" / "_lora_b": fp32 tensor} as the LoRA
    generator seeded `seed` draws them."""
    gen = torch.Generator(device=device).manual_seed(seed)
    scale = alpha / rank
    out: Dict[str, torch.Tensor] = {}
    for i, lp in enumerate(layers):
        for t in ALL_LINEAR:
            if t not in lp:
                continue
            d_out, d_in = lp[t].shape
            a = torch.randn((rank, d_in), generator=gen, device=device, dtype=torch.float32).mul_(rank ** -0.5)
            out[f"{i}.{t}_lora_a"] = a.mul_(scale) if scale != 1.0 else a
            out[f"{i}.{t}_lora_b"] = torch.zeros((d_out, rank), device=device, dtype=torch.float32)
    return out


def _decoder_nll(w32: List[Dict], top: Dict, llm: Dict, adapters: Dict[str, torch.Tensor], x: torch.Tensor,
                 lengths: torch.Tensor, labels: torch.Tensor, lowp: Optional[str]) -> torch.Tensor:
    """Summed NLL of the labelled next tokens of a block of rows (`lowp`
    "int8": the base products and the head w8a8, gradients straight through)."""
    b, t, d = x.shape
    h, hkv = llm["n_heads"], llm["n_kv_heads"]
    hd = d // h
    rd, eps, phi = int(llm["rotary_pct"] * hd), llm["norm_eps"], llm["arch"] == "phi"
    pos = torch.arange(t, device=x.device)
    r = torch.arange(t, device=x.device)
    ok = (r[None, :] <= r[:, None])[None] & (r[None, None, :] < lengths[:, None, None])
    window = llm.get("sliding_window")
    if window is not None:
        ok = ok & (r[None, :] > r[:, None] - window)[None]

    def proj(i: int, name: str, lp: Dict, v: torch.Tensor) -> torch.Tensor:
        y = linear(v, lp[name], lowp)
        a = adapters.get(f"{i}.{name}_lora_a")
        return y if a is None else y + (v @ a.T) @ adapters[f"{i}.{name}_lora_b"].T

    for i, lp in enumerate(w32):
        hin = F.layer_norm(x, (d,), lp["attn_norm"], lp["attn_norm_bias"], eps) if phi else rms_norm(x, lp["attn_norm"], eps)
        q, k, v = (proj(i, n, lp, hin) for n in ("wq", "wk", "wv"))
        if phi:
            q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
        q = rope(q.reshape(b * t, h, hd), pos.repeat(b), rd, llm["rope_theta"]).view(b, t, h, hd)
        k = rope(k.reshape(b * t, hkv, hd), pos.repeat(b), rd, llm["rope_theta"]).view(b, t, hkv, hd)
        v = v.view(b, t, hkv, hd)
        kk, vv = k.repeat_interleave(h // hkv, dim=2), v.repeat_interleave(h // hkv, dim=2)
        scores = torch.einsum("bthd,bshd->bhts", q, kk) / math.sqrt(hd)
        scores = scores.masked_fill(~ok[:, None], float("-inf"))
        attn = torch.einsum("bhts,bshd->bthd", scores.softmax(dim=-1), vv).reshape(b, t, h * hd)
        o = proj(i, "wo", lp, attn)
        if phi:
            up = _gelu(proj(i, "w_up", lp, hin) + lp["b_up"], "gelu_tanh")
            x = x + o + lp["bo"] + proj(i, "w_down", lp, up) + lp["b_down"]
        else:
            x = x + o
            h2 = rms_norm(x, lp["mlp_norm"], eps)
            g, u = proj(i, "w_gate", lp, h2), proj(i, "w_up", lp, h2)
            x = x + proj(i, "w_down", lp, g * torch.sigmoid(g) * u)
    if phi:
        x = F.layer_norm(x, (d,), top["final_norm"], top["final_norm_bias"], eps)
    else:
        x = rms_norm(x, top["final_norm"], eps)
    logits = linear(x[:, :-1], top["lm_head"], lowp)
    if phi:
        logits = logits + top["lm_head_bias"]
    y = labels[:, 1:]
    valid = y != IGNORE
    logp = torch.log_softmax(logits, dim=-1).gather(-1, y.clamp(min=0)[..., None])[..., 0]
    return -(logp * valid).sum()


def lora_steps(params: Dict, cfg: Dict, adapters: Dict[str, torch.Tensor], batches: Sequence[Dict],
               opt: Dict, row_block: int, lowp: Optional[str] = None) -> Dict[str, object]:
    """Run len(batches) steps from `adapters` (updated in place). Each batch:
    frames [B, H, W, 3] uint8, input_ids, labels, attention_mask [B, L]
    (tensors on the device). Returns the losses, each step's clipped
    gradient norms per leaf, and the adapters' change per leaf. `lowp`
    "int8" is the lower-precision control: every base linear layer (towers,
    projector, decoder, head) w8a8."""
    llm = cfg["port"]["llm"]
    lw = params["llm"]
    w32 = [{k: v.float() for k, v in lp.items()} for lp in lw["layers"]]
    top = {k: v.float() for k, v in lw.items() if k != "layers"}
    start = {k: v.detach().clone() for k, v in adapters.items()}
    names = list(adapters)
    mu = {k: torch.zeros_like(v) for k, v in adapters.items()}
    nu = {k: torch.zeros_like(v) for k, v in adapters.items()}
    losses, grad_norms = [], []
    for step, batch in enumerate(batches, start=1):
        ids, labels, mask = batch["input_ids"].long(), batch["labels"].long(), batch["attention_mask"].long()
        b = ids.shape[0]
        with torch.no_grad():
            patches = vision_embeddings(params, cfg, batch["frames"], lowp)
        p = patches.shape[1]
        ones = torch.ones((b, p), dtype=mask.dtype, device=mask.device)
        fused_mask = torch.cat([mask[:, :1], ones, mask[:, 1:]], dim=1)
        fused_labels = torch.cat([labels[:, :1], torch.full_like(ones, IGNORE), labels[:, 1:]], dim=1)
        count = int((fused_labels[:, 1:] != IGNORE).sum())
        leaves = [adapters[k].requires_grad_(True) for k in names]
        grads = [torch.zeros_like(v) for v in leaves]
        total = 0.0
        for a in range(0, b, row_block):
            sl = slice(a, a + row_block)
            te = top["embed"][ids[sl]]
            x = torch.cat([te[:, :1], patches[sl], te[:, 1:]], dim=1)
            nll = _decoder_nll(w32, top, llm, adapters, x, fused_mask[sl].sum(dim=1), fused_labels[sl], lowp) / count
            for g, gi in zip(grads, torch.autograd.grad(nll, leaves)):
                g.add_(gi)
            total += float(nll.detach())
        for v in leaves:
            v.requires_grad_(False)
        losses.append(total)
        norm = math.sqrt(sum(float(g.double().square().sum()) for g in grads))
        clip = 1.0 if norm < opt["max_norm"] else opt["max_norm"] / norm
        grads = [g * clip for g in grads]
        grad_norms.append({k: float(g.norm()) for k, g in zip(names, grads)})
        bc1, bc2 = 1.0 - opt["b1"] ** step, 1.0 - opt["b2"] ** step
        with torch.no_grad():
            for k, g in zip(names, grads):
                mu[k].mul_(opt["b1"]).add_(g, alpha=1.0 - opt["b1"])
                nu[k].mul_(opt["b2"]).addcmul_(g, g, value=1.0 - opt["b2"])
                adapters[k].sub_(opt["lr"] * (mu[k] / bc1) / ((nu[k] / bc2).sqrt() + opt["eps"]))
    change = {k: float((adapters[k] - start[k]).norm()) for k in names}
    return {"losses": losses, "grad_norms": grad_norms, "change": change}
