"""Architecture config schema (a copy of the reference package's schema, so the
port imports nothing of it)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    expert_ff: int
    shared_ff: int = 0
    n_dense_prologue: int = 0      # leading dense layers (deepseek: 3, kimi: 1)
    dense_ff: int = 0              # ffn width of the dense prologue layers
    bias_free_balance: bool = True  # DeepSeek-style aux-loss-free router bias


@dataclasses.dataclass(frozen=True)
class MLACfg:
    q_lora: int = 1536
    kv_lora: int = 512
    d_nope: int = 128
    d_rope: int = 64
    d_v: int = 128


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 64
    headdim: int = 64
    expand: int = 2
    d_conv: int = 4
    n_groups: int = 1
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    norm: str = "rms"            # rms | rms+1 | ln
    mlp: str = "swiglu"          # swiglu | geglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    pattern: tuple[str, ...] = ("attn",)
    # gemma2-isms
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    window: int = 0              # sliding window for attn_local blocks
    attn_scale: float | None = None
    post_norm: bool = False
    embed_scale: bool = False    # gemma multiplies embeddings by sqrt(d)
    # family extensions
    moe: MoECfg | None = None
    mla: MLACfg | None = None
    ssm: SSMCfg | None = None
    mlstm_heads: int = 4
    # vlm / audio frontends (stubs produce the aux embeddings)
    n_aux_tokens: int = 0        # image patch tokens / audio frames
    encoder_layers: int = 0      # whisper encoder depth
    mtp: bool = False            # deepseek multi-token-prediction head

    @property
    def n_groups(self) -> int:
        body = self.n_layers - (self.moe.n_dense_prologue if self.moe else 0) \
            - self.encoder_layers
        assert body % len(self.pattern) == 0, (
            f"{self.name}: {body} body layers not divisible by pattern "
            f"{len(self.pattern)}")
        return body // len(self.pattern)

    @property
    def d_head_total(self) -> int:
        return self.n_heads * self.head_dim

    def active_params(self) -> float:
        """Analytic active-parameter count (for MODEL_FLOPS = 6*N*D)."""
        d, v = self.d_model, self.vocab
        n = v * d  # embedding (tied head counted once; lm head flops counted via 6ND anyway)
        for kind in self.pattern * self.n_groups:
            n += self._block_params(kind, active=True)
        if self.moe and self.moe.n_dense_prologue:
            n += self.moe.n_dense_prologue * self._block_params("attn_dense", active=True)
        if self.encoder_layers:
            n += self.encoder_layers * self._block_params("enc", active=True)
        return float(n)

    def total_params(self) -> float:
        d, v = self.d_model, self.vocab
        n = v * d
        for kind in self.pattern * self.n_groups:
            n += self._block_params(kind, active=False)
        if self.moe and self.moe.n_dense_prologue:
            n += self.moe.n_dense_prologue * self._block_params("attn_dense", active=False)
        if self.encoder_layers:
            n += self.encoder_layers * self._block_params("enc", active=False)
        return float(n)

    def _block_params(self, kind: str, active: bool) -> float:
        d = self.d_model
        attn = d * self.n_heads * self.head_dim * 2 \
            + d * self.n_kv_heads * self.head_dim * 2
        if self.mla:
            m = self.mla
            attn = (d * m.q_lora + m.q_lora * self.n_heads * (m.d_nope + m.d_rope)
                    + d * (m.kv_lora + m.d_rope)
                    + m.kv_lora * self.n_heads * (m.d_nope + m.d_v)
                    + self.n_heads * m.d_v * d)
        mlp_mult = 3 if self.mlp in ("swiglu", "geglu") else 2
        ffn = mlp_mult * d * self.d_ff
        if kind.startswith("attn_dense") and self.moe:
            return attn + mlp_mult * d * self.moe.dense_ff
        if kind == "moe":
            e_used = self.moe.top_k if active else self.moe.n_experts
            moe_ffn = e_used * 3 * d * self.moe.expert_ff \
                + 3 * d * self.moe.shared_ff + d * self.moe.n_experts
            return attn + moe_ffn
        if kind == "mamba":
            s = self.ssm
            d_in = s.expand * d
            nh = d_in // s.headdim
            return d * (2 * d_in + 2 * s.n_groups * s.d_state + nh) + d_in * d
        if kind in ("mlstm", "slstm"):
            return 5 * d * d
        if kind in ("cross", "enc", "dec"):
            return attn + ffn + (attn if kind == "dec" else 0)
        if kind == "shared_attn":
            # shared weights: count once across all groups when inactive?
            # counted per-use for FLOPs purposes (active) — weight reuse.
            return attn + ffn
        return attn + ffn
