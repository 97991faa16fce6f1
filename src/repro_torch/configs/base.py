"""Config system: architecture configs, input shapes, and the registry.

Every assigned architecture gets one file in this package defining a
``ModelConfig`` with the exact public-literature numbers and registering it
under its assigned id.  Configs are plain dataclasses (no jax import) so that
importing them never touches device state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------

ARCH_TYPES = ("dense", "moe", "ssm", "hybrid", "encoder", "vlm")


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration."""

    n_experts: int = 8             # routed experts
    n_shared_experts: int = 0      # always-on experts (DeepSeekMoE)
    top_k: int = 2
    d_expert: int = 0              # per-expert hidden dim (0 => use d_ff)
    router_jitter: float = 0.0
    load_balance_coef: float = 0.01
    capacity_factor: float = 1.25  # used by dense-dispatch einsum MoE


@dataclass(frozen=True)
class SSMConfig:
    """State-space / linear-attention mixer configuration."""

    kind: str = "mamba2"           # "mamba2" | "rwkv6"
    d_state: int = 64              # recurrent state size per head-channel
    d_conv: int = 4                # depthwise conv width (mamba)
    head_dim: int = 64             # SSD / WKV head dim
    expand: int = 2                # mamba inner expansion factor
    chunk_size: int = 128          # chunked-scan block length


@dataclass(frozen=True)
class ModelConfig:
    """A single architecture's full configuration."""

    name: str
    arch_type: str                 # one of ARCH_TYPES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 => d_model // n_heads
    # --- attention details ---
    rope_theta: float = 10000.0
    qk_norm: bool = False
    causal: bool = True
    sliding_window: int = 0        # 0 => full attention
    mrope_sections: Tuple[int, ...] = ()   # VLM M-RoPE (t, h, w) splits
    # --- hybrid layout ---
    attn_every: int = 0            # >0: attention applied every k-th layer
    shared_attn_params: bool = False  # Zamba2: one attn block reused at depth
    long_context_window: int = 0   # SWA window applied only in long mode
    frontend_dim: int = 0          # stubbed modality frontend embed dim
    # --- subsystem configs ---
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # --- misc ---
    norm_eps: float = 1e-5
    act: str = "swiglu"            # "swiglu" | "gelu"
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # long-context policy: "swa" archs can serve long_500k with window cache
    long_context_mode: str = "none"   # "none" | "swa" | "recurrent"
    citation: str = ""

    # ------------------------------------------------------------------
    def __post_init__(self):
        assert self.arch_type in ARCH_TYPES, self.arch_type
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ------------------------------------------------------------------
    # derived quantities used by the roofline + the memory cost simulator
    # ------------------------------------------------------------------
    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def supports_decode(self) -> bool:
        return self.arch_type != "encoder"

    @property
    def supports_long_context(self) -> bool:
        return self.long_context_mode != "none"

    def layer_plan(self) -> list:
        """Return [(kind, count), ...] describing homogeneous layer groups.

        kinds: 'attn' (attention+ffn), 'mamba' (mamba mixer), 'hybrid'
        (mamba mixer + shared attention block), 'wkv' (rwkv6 mixer +
        channel-mix).  Groups with count>1 are scanned over stacked params.
        """
        if self.arch_type == "ssm":
            kind = self.ssm.kind if self.ssm is not None else "rwkv6"
            return [("mamba" if kind == "mamba2" else "wkv",
                     self.n_layers)]
        if self.arch_type == "hybrid":
            k = max(self.attn_every, 1)
            n_super, rem = divmod(self.n_layers, k)
            plan = []
            if n_super > 0:
                plan.append(("hybrid_super", n_super))  # k-1 mamba + 1 hybrid
            if rem:
                plan.append(("mamba", rem))
            return plan
        return [("attn", self.n_layers)]

    # -- parameter count (analytic, matches the model builders) ---------
    def param_count(self) -> int:
        d, hd = self.d_model, self.head_dim
        nh, nkv = self.n_heads, self.n_kv_heads
        emb = self.vocab_size * d
        out = 0 if self.tie_embeddings else self.vocab_size * d
        n = emb + out + d  # final norm

        def attn_params() -> int:
            p = d * nh * hd + 2 * d * nkv * hd + nh * hd * d  # q,k,v,o
            if self.qk_norm:
                p += 2 * hd
            return p + d  # pre-norm

        def ffn_dense(dff: int) -> int:
            mult = 3 if self.act == "swiglu" else 2
            return mult * d * dff + d  # + pre-norm

        if self.arch_type in ("dense", "vlm", "encoder"):
            n += self.n_layers * (attn_params() + ffn_dense(self.d_ff))
        elif self.arch_type == "moe":
            m = self.moe
            de = m.d_expert or self.d_ff
            per = attn_params()
            per += (m.n_experts + m.n_shared_experts) * 3 * d * de
            per += d * m.n_experts  # router
            per += d  # ffn pre-norm
            n += self.n_layers * per
        elif self.arch_type == "ssm":
            s = self.ssm
            if s is not None and s.kind == "mamba2":
                d_in = s.expand * d
                d_xbc = d_in + 2 * s.d_state
                # z/xbc/dt projections + conv + out proj + norms
                per = d * (d_in + d_xbc + d_in // s.head_dim) \
                    + s.d_conv * d_xbc + d_in * d + d_in + d
            else:
                # rwkv6: time-mix (r,k,v,g,o ~ 5 d^2) + channel mix
                per = 5 * d * d + 2 * d * self.d_ff + 2 * d
                per += 6 * d  # decay/bonus/token-shift params (approx)
            n += self.n_layers * per
        elif self.arch_type == "hybrid":
            s = self.ssm
            d_in = s.expand * d
            mamba = d * (2 * d_in + 2 * s.d_state + d_in // s.head_dim) \
                + d_in * d + d_in * s.d_conv + d
            n_attn = (self.n_layers // max(self.attn_every, 1))
            if self.shared_attn_params:
                n_attn = min(n_attn, 1)
            n += self.n_layers * mamba
            n += n_attn * (attn_params() + ffn_dense(self.d_ff))
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k experts)."""
        if self.arch_type != "moe":
            return self.param_count()
        m = self.moe
        de = m.d_expert or self.d_ff
        inactive = (m.n_experts - m.top_k) * 3 * self.d_model * de
        return self.param_count() - self.n_layers * inactive

    def kv_bytes_per_token(self, bytes_per_el: int = 2) -> int:
        """KV-cache bytes appended per decoded token (attention layers)."""
        if self.arch_type == "ssm":
            return 0
        n_attn_layers = self.n_layers
        if self.arch_type == "hybrid":
            n_attn_layers = self.n_layers // max(self.attn_every, 1)
        return n_attn_layers * 2 * self.n_kv_heads * self.head_dim * bytes_per_el

    def state_bytes_per_branch(self, bytes_per_el: int = 4) -> int:
        """Recurrent-state bytes per live branch (SSM/hybrid)."""
        if self.arch_type not in ("ssm", "hybrid"):
            return 0
        s = self.ssm
        if s.kind == "rwkv6":
            n_heads = self.d_model // s.head_dim
            per_layer = n_heads * s.head_dim * s.head_dim + 2 * self.d_model
        else:  # mamba2
            d_in = s.expand * self.d_model
            n_heads = d_in // s.head_dim
            per_layer = n_heads * s.head_dim * s.d_state + d_in * s.d_conv
        n_ssm_layers = self.n_layers
        if self.arch_type == "hybrid":
            n_ssm_layers = self.n_layers  # every layer has a mamba mixer
        return n_ssm_layers * per_layer * bytes_per_el

    def flops_per_token(self, seq_len: int = 0) -> float:
        """Approximate forward FLOPs per token (6ND/3 = 2ND + attention)."""
        base = 2.0 * self.active_param_count()
        if seq_len and not self.is_attention_free:
            w = seq_len if not self.sliding_window else min(seq_len, self.sliding_window)
            n_attn = self.n_layers
            if self.arch_type == "hybrid":
                n_attn = self.n_layers // max(self.attn_every, 1)
            base += 2.0 * 2.0 * n_attn * self.n_heads * self.head_dim * w
        return base


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate config {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    from . import _ensure_loaded  # noqa: avoid circular at module import
    _ensure_loaded()
    return _REGISTRY[name]


def list_configs() -> list:
    from . import _ensure_loaded
    _ensure_loaded()
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# Reduced variants for CPU smoke tests
# ---------------------------------------------------------------------------

def tiny_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config: 2 layers, d_model<=512, <=4 experts."""
    d_model = min(cfg.d_model, 256)
    head_dim = 32
    n_heads = max(d_model // 64, 2)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    # keep the GQA ratio flavour: if original had fewer kv heads, halve
    if cfg.n_kv_heads < cfg.n_heads:
        n_kv = max(1, n_heads // 2)
    kw = dict(
        name=cfg.name + "-tiny",
        arch_type=cfg.arch_type,
        n_layers=2 if cfg.arch_type != "hybrid" else max(2, cfg.attn_every),
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 512),
        rope_theta=cfg.rope_theta,
        qk_norm=cfg.qk_norm,
        causal=cfg.causal,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        long_context_window=(min(cfg.long_context_window, 64)
                             if cfg.long_context_window else 0),
        frontend_dim=64 if cfg.frontend_dim else 0,
        mrope_sections=(8, 4, 4) if cfg.mrope_sections else (),
        attn_every=cfg.attn_every if cfg.arch_type == "hybrid" else 0,
        shared_attn_params=cfg.shared_attn_params,
        norm_eps=cfg.norm_eps,
        act=cfg.act,
        dtype="float32",
        long_context_mode=cfg.long_context_mode,
    )
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(
            n_experts=min(cfg.moe.n_experts, 4),
            n_shared_experts=min(cfg.moe.n_shared_experts, 1),
            top_k=min(cfg.moe.top_k, 2),
            d_expert=min(cfg.moe.d_expert or kw["d_ff"], 128),
            # dropless at test scale so chunk/step paths agree exactly
            capacity_factor=float(min(cfg.moe.n_experts, 4)),
        )
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(
            kind=cfg.ssm.kind,
            d_state=min(cfg.ssm.d_state, 16),
            d_conv=cfg.ssm.d_conv,
            head_dim=32,
            expand=cfg.ssm.expand,
            chunk_size=32,
        )
    return ModelConfig(**kw)
