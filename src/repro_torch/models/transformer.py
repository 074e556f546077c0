"""Decoder-only transformer LM (counterpart of ``repro.models.transformer``):
GQA + RoPE + (SWA | full) attention, SwiGLU or GELU dense MLP.

One implementation covers llama3.2-3b, starcoder2-7b and qwen2-72b via
:class:`TransformerConfig`.  Inference paths, all under
``torch.inference_mode()``:

  forward()      full-sequence causal LM (scoring)
  prefill()      fills a KV cache, returns last-position logits
  decode_step()  one-token decode against the cache (dense or rolling/SWA)

Parameters are a nested dict in the reference's layout, layers stacked on
axis 0 (``params["layers"]["attn"]["wq"]["w"]`` is ``[L, d_model, d_q]``),
so :func:`params_from_reference` is a copy of the JAX tree.  What the
reference does that has nothing to do here is dropped: ``shard(...)`` is the
identity outside a mesh (the mesh slice brings sharding), ``remat`` changes
no output of inference, and the layer scan is a Python loop.  ``cfg.moe``
raises: the MoE FFN is ROADMAP Queue 1, item 12.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.graph.edgelist import Device, resolve_device
from repro_torch.models.attention import (
    KVCacheSpec,
    Lengths,
    cache_update,
    decode_attention,
    gqa_attention,
    lengths,
)
from repro_torch.models.common import apply_rope, dense, layernorm, rmsnorm, trunc_normal

_MOE = "cfg.moe: the MoE FFN (models/moe.py) is not ported yet, ROADMAP Queue 1 item 12"


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    mlp_type: str = "swiglu"  # swiglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    qkv_bias: bool = False
    rope_theta: float = 500_000.0
    window: Optional[int] = None  # sliding-window attention (Mixtral)
    moe: Optional[Any] = None
    tie_embeddings: bool = False
    compute_dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True
    attn_impl: str = "xla"  # xla | pallas
    q_chunk: int = 512  # flash chunk sizes (xla_chunked / auto path)
    kv_chunk: int = 1024
    z_loss: float = 1e-4

    @property
    def d_q(self) -> int:
        return self.n_heads * self.d_head

    @property
    def d_kv(self) -> int:
        return self.n_kv_heads * self.d_head

    def param_count(self) -> int:
        """Analytic parameter count."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        attn = d * self.d_q + 2 * d * self.d_kv + self.d_q * d
        if self.qkv_bias:
            attn += self.d_q + 2 * self.d_kv
        if self.moe is not None:
            ffn = self.moe.n_experts * 3 * d * f + d * self.moe.n_experts
        else:
            ffn = (3 if self.mlp_type == "swiglu" else 2) * d * f
        per_layer = attn + ffn + 2 * d
        head = 0 if self.tie_embeddings else d * v
        return v * d + self.n_layers * per_layer + d + head


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

# Path-pattern sharding rules of the reference, as data: unused until the
# mesh slice (each is (regex on the parameter path, logical axes)).
LM_PARAM_RULES = [
    (r"embed/w", ("tp", "fsdp")),
    (r"layers/attn/w[qkv]/w", (None, "fsdp", "tp")),
    (r"layers/attn/w[qkv]/b", (None, "tp")),
    (r"layers/attn/wo/w", (None, "tp", "fsdp")),
    (r"layers/moe/router/w", (None, "fsdp", None)),
    (r"layers/moe/w_(gate|up)", (None, "expert", "fsdp", "tp")),
    (r"layers/moe/w_down", (None, "expert", "tp", "fsdp")),
    (r"layers/mlp/w_(gate|up)/w", (None, "fsdp", "tp")),
    (r"layers/mlp/w_down/w", (None, "tp", "fsdp")),
    (r"layers/mlp/.*/b", (None, None)),
    (r"lm_head/w", ("fsdp", "tp")),
    (r"layers/ln[12]/(scale|bias)", (None, None)),
    (r"final_norm/(scale|bias)", (None,)),
]


def param_spec(cfg: TransformerConfig) -> Dict[str, Any]:
    """Every parameter as ``(shape, init)``, nested as the reference nests
    them; init is ``("trunc", std)``, ``("normal", std)``, ``"ones"`` or
    ``"zeros"``."""
    if cfg.moe is not None:
        raise NotImplementedError(_MOE)
    L, d = cfg.n_layers, cfg.d_model

    def dense_spec(d_in, d_out, bias=False):
        p = {"w": ((L, d_in, d_out), ("trunc", 1.0 / np.sqrt(d_in)))}
        if bias:
            p["b"] = ((L, d_out), "zeros")
        return p

    def norm_spec(lead):
        p = {"scale": ((*lead, d), "ones")}
        if cfg.norm != "rmsnorm":
            p["bias"] = ((*lead, d), "zeros")
        return p

    layers = {
        "ln1": norm_spec((L,)),
        "ln2": norm_spec((L,)),
        "attn": {
            "wq": dense_spec(d, cfg.d_q, cfg.qkv_bias),
            "wk": dense_spec(d, cfg.d_kv, cfg.qkv_bias),
            "wv": dense_spec(d, cfg.d_kv, cfg.qkv_bias),
            "wo": dense_spec(cfg.d_q, d),
        },
    }
    if cfg.mlp_type == "swiglu":
        layers["mlp"] = {
            "w_gate": dense_spec(d, cfg.d_ff),
            "w_up": dense_spec(d, cfg.d_ff),
            "w_down": dense_spec(cfg.d_ff, d),
        }
    else:  # gelu
        layers["mlp"] = {
            "w_up": dense_spec(d, cfg.d_ff, bias=True),
            "w_down": dense_spec(cfg.d_ff, d, bias=True),
        }
    spec = {
        "embed": {"w": ((cfg.vocab, d), ("normal", 0.02))},
        "layers": layers,
        "final_norm": norm_spec(()),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = {"w": ((d, cfg.vocab), ("trunc", 1.0 / np.sqrt(d)))}
    return spec


def _map_spec(spec, fn, path=""):
    if isinstance(spec, dict):
        return {k: _map_spec(v, fn, f"{path}/{k}" if path else k) for k, v in spec.items()}
    return fn(path, *spec)


def init_params(cfg: TransformerConfig, generator: torch.Generator, device: Device = None):
    """Parameters drawn from ``generator`` with the reference's
    distributions (truncated normal at 1/sqrt(d_in) for dense weights,
    N(0, 0.02^2) for the embedding, ones and zeros for norms and biases),
    in ``cfg.param_dtype`` on ``device`` (default: the card; the generator
    must live on the same device)."""
    dev = resolve_device(device)
    dt = cfg.param_dtype

    def draw(path, shape, init):
        if init == "ones":
            return torch.ones(shape, dtype=dt, device=dev)
        if init == "zeros":
            return torch.zeros(shape, dtype=dt, device=dev)
        kind, std = init
        if kind == "trunc":
            return trunc_normal(generator, shape, float(std), dt, dev)
        t = torch.empty(shape, dtype=dt, device=dev)
        return t.normal_(0.0, 1.0, generator=generator).mul_(std)

    with torch.inference_mode():
        return _map_spec(param_spec(cfg), draw)


def params_from_reference(tree, cfg: TransformerConfig, device: Device = None):
    """The reference's parameter tree (numpy arrays, or anything
    ``numpy.asarray`` takes; layers stacked on axis 0) as the port's
    parameters, in ``cfg.param_dtype`` on ``device`` (default: the card)."""
    dev = resolve_device(device)

    def take(path, shape, _init):
        node = tree
        for key in path.split("/"):
            node = node[key]
        a = np.asarray(node)
        if a.shape != shape:
            raise ValueError(f"{path}: shape {a.shape}, the config gives {shape}")
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev, cfg.param_dtype)

    return _map_spec(param_spec(cfg), take)


def layer_params(params, i: int):
    """Layer ``i``'s parameters: views into the stacked tensors."""
    def pick(node):
        return {k: pick(v) for k, v in node.items()} if isinstance(node, dict) else node[i]

    return pick(params["layers"])


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _norm(cfg, p, x):
    return rmsnorm(p, x) if cfg.norm == "rmsnorm" else layernorm(p, x)


def _embed(cfg, params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"]["w"][tokens.long()].to(cfg.compute_dtype)


def _attention_block(cfg, p, x, positions):
    """Full-sequence causal attention (scoring / prefill); returns (out, k, v)."""
    cd = cfg.compute_dtype
    b, s, _ = x.shape
    h = _norm(cfg, p["ln1"], x)
    q = dense(p["attn"]["wq"], h, cd).reshape(b, s, cfg.n_heads, cfg.d_head)
    k = dense(p["attn"]["wk"], h, cd).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = dense(p["attn"]["wv"], h, cd).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = gqa_attention(
        q, k, v,
        q_positions=positions, kv_positions=positions,
        window=cfg.window, impl=cfg.attn_impl,
    )
    out = dense(p["attn"]["wo"], out.reshape(b, s, cfg.d_q), cd)
    return x + out.to(x.dtype), k, v


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``, op by op in x's dtype as XLA lowers it (each op
    rounds: in bf16 one fused sigmoid differs from it in a third of the
    elements)."""
    return x * (1 / (1 + torch.exp(-x)))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)``, op by op in x's dtype, with its
    constants rounded to that dtype first (XLA's weak typing)."""
    def c(value):
        return float(torch.tensor(value, dtype=x.dtype))

    cdf = 0.5 * (1.0 + torch.tanh(c(np.sqrt(2 / np.pi)) * (x + c(0.044715) * (x * x * x))))
    return x * cdf


def _ffn_block(cfg, p, x):
    cd = cfg.compute_dtype
    h = _norm(cfg, p["ln2"], x)
    if cfg.mlp_type == "swiglu":
        g = dense(p["mlp"]["w_gate"], h, cd)
        u = dense(p["mlp"]["w_up"], h, cd)
        y = dense(p["mlp"]["w_down"], _silu(g) * u, cd)
    else:
        u = dense(p["mlp"]["w_up"], h, cd)
        y = dense(p["mlp"]["w_down"], _gelu(u), cd)
    return x + y.to(x.dtype)


def _logits(cfg, params, x) -> torch.Tensor:
    """f32 logits of the compute-dtype operands (the reference's
    preferred_element_type=float32)."""
    cd = cfg.compute_dtype
    h = _norm(cfg, params["final_norm"], x).to(cd).float()
    if cfg.tie_embeddings:
        return h @ params["embed"]["w"].to(cd).float().T
    return h @ params["lm_head"]["w"].to(cd).float()


def _check_cfg(cfg: TransformerConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError(_MOE)


@torch.inference_mode()
def forward(params, cfg: TransformerConfig, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal LM forward: tokens int[B, S] -> (logits f32[B, S, V], moe_loss),
    on the tokens' device; moe_loss is 0 (no experts in the ported configs)."""
    _check_cfg(cfg)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    x = _embed(cfg, params, tokens)
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        x, _, _ = _attention_block(cfg, p, x, positions)
        x = _ffn_block(cfg, p, x)
    return _logits(cfg, params, x), torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------


def cache_spec(cfg: TransformerConfig, batch: int, seq_len: int) -> KVCacheSpec:
    max_len = seq_len if cfg.window is None else cfg.window
    return KVCacheSpec(
        batch=batch, n_layers=cfg.n_layers, max_len=max_len,
        n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
    )


@torch.inference_mode()
def prefill(params, cfg: TransformerConfig, tokens: torch.Tensor, extra_slots: int = 0):
    """Processes the prompt; returns (last-position logits f32[B, V], cache,
    cur_len).

    The cache (``{"k", "v"}``, each ``[L, B, M, Hkv, D]`` in bf16) stores the
    last ``min(S, window)`` positions (rolling for SWA: slot = position %
    window, unfilled slots zero).  ``extra_slots`` reserves empty slots after
    the prompt for subsequent dense-cache decode steps (rolling caches need
    none).  ``cur_len`` is the prompt length, a Python int.
    """
    _check_cfg(cfg)
    b, s = tokens.shape
    dev = tokens.device
    positions = torch.arange(s, dtype=torch.int32, device=dev)
    x = _embed(cfg, params, tokens)
    spec = cache_spec(cfg, b, s)
    m = spec.max_len
    extra = extra_slots if cfg.window is None else 0
    shape = (cfg.n_layers, b, m + extra, cfg.n_kv_heads, cfg.d_head)
    cache = {"k": torch.zeros(shape, dtype=spec.dtype, device=dev),
             "v": torch.zeros(shape, dtype=spec.dtype, device=dev)}
    keep = min(s, m)
    slots = (positions[-keep:] % m).long()
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        x, k, v = _attention_block(cfg, p, x, positions)
        x = _ffn_block(cfg, p, x)
        if cfg.window is None:
            cache["k"][i, :, :s] = k
            cache["v"][i, :, :s] = v
        else:
            cache["k"][i][:, slots] = k[:, -keep:].to(spec.dtype)
            cache["v"][i][:, slots] = v[:, -keep:].to(spec.dtype)
    logits = _logits(cfg, params, x[:, -1:, :])
    return logits[:, 0], cache, s


@torch.inference_mode()
def decode_step(params, cfg: TransformerConfig, cache, tokens: torch.Tensor, cur_len: Lengths):
    """One decode step: tokens int[B, 1] at position ``cur_len`` (one int for
    every row, or int[B], one per row: each row's own mask and RoPE).

    Writes the new K/V into ``cache`` IN PLACE (the reference returns a new
    cache) and returns (logits f32[B, V], cache, cur_len + 1).
    """
    _check_cfg(cfg)
    b = tokens.shape[0]
    cd = cfg.compute_dtype
    x = _embed(cfg, params, tokens)
    cur = lengths(cur_len, b, tokens.device)
    positions = cur[:, None]
    rolling = cfg.window is not None
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        ck, cv = cache["k"][i], cache["v"][i]
        h = _norm(cfg, p["ln1"], x)
        q = dense(p["attn"]["wq"], h, cd).reshape(b, 1, cfg.n_heads, cfg.d_head)
        k = dense(p["attn"]["wk"], h, cd).reshape(b, 1, cfg.n_kv_heads, cfg.d_head)
        v = dense(p["attn"]["wv"], h, cd).reshape(b, 1, cfg.n_kv_heads, cfg.d_head)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        cache_update(ck, cv, k, v, cur, rolling)
        out = decode_attention(q, ck, cv, cur, window=cfg.window, impl=cfg.attn_impl)
        x = x + dense(p["attn"]["wo"], out.reshape(b, 1, cfg.d_q), cd).to(x.dtype)
        x = _ffn_block(cfg, p, x)
    logits = _logits(cfg, params, x)
    return logits[:, 0], cache, cur_len + 1
