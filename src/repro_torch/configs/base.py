"""Config dataclasses: model architecture, input shapes and federated setup.

Plain frozen dataclasses, as in ``repro.configs.base``. Only the fields the
ported families (resnet, dense, ssm, moe, hybrid, encoder, vlm) and the
sync engines (flat and hierarchical) read are carried over; the
reference's ``remat`` is not (the port keeps every activation).
``ExpertShareConfig`` is the port's own: one device's share of an MoE
config's experts.
"""

from __future__ import annotations

import dataclasses
import math

VOCAB_PAD = 256  # the vocab is padded to a multiple of this, as in the reference


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture. ``family`` selects the model implementation."""

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    citation: str = ""
    # attention details
    head_dim: int = 0                 # 0 ⇒ d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0           # 0 ⇒ full attention
    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    # hybrid (zamba2): one shared attention block applied every N layers
    shared_attn_every: int = 0
    # vlm: cross-attention layer period & vision stub
    cross_attn_every: int = 0
    vision_tokens: int = 1601         # (1 tile × 40×40 patches + cls) stub
    # encoder-only (hubert): masked-prediction frontend stub
    is_encoder: bool = False
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # vision classification (resnet)
    image_size: int = 32
    num_classes: int = 10

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def padded_vocab(self) -> int:
        return int(math.ceil(self.vocab_size / VOCAB_PAD) * VOCAB_PAD)

    @property
    def expert_range(self) -> range:
        """The experts whose weights this config holds: all of them."""
        return range(self.num_experts)

    @property
    def expert_deployment(self) -> str:
        """The deployment the experts held here stand for, in words."""
        here, e = self.expert_range, self.num_experts
        if len(here) == e:
            return f"all {e} experts on one device"
        return (f"experts {here.start}-{here.stop - 1} of {e}: one device's share "
                f"of {e} experts over {e // len(here)} devices, {len(here)} each")

    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input shape of the reference (``configs.shapes``)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


@dataclasses.dataclass(frozen=True)
class ExpertShareConfig(ModelConfig):
    """One device's share of an MoE config (``registry.expert_share``):
    experts [first_expert, first_expert + experts_here) hold weights here,
    the router still scores all ``num_experts`` and routes top-k over them,
    and a token's pairs with an absent expert add nothing (that device's
    part is not computed). The per-shard expert set of the reference's
    expert-parallel layer (``_moe_ffn_a2a``), run without its all-to-all."""

    experts_here: int = 0
    first_expert: int = 0

    @property
    def expert_range(self) -> range:
        return range(self.first_expert, self.first_expert + self.experts_here)


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """Federated-learning control-plane configuration (paper Sec IV)."""

    num_clients: int = 12
    participation: float = 0.5
    rounds: int = 100
    local_epochs: int = 5
    local_batch: int = 32
    lr: float = 0.01
    mu: float = 0.1                 # FedProx proximal coefficient
    selector: str = "heterosel"
    dirichlet_alpha: float = 0.1
    seed: int = 0
    # 'batched' (one vmapped call per cohort) | 'sequential' (one call per
    # client, the numerical reference).
    client_execution: str = "batched"
    # With 'batched': > 0 caps the per-call cohort at this many clients.
    client_chunk: int = 0
    # Only 'sync' is ported; FederatedSpec.build refuses 'async'.
    round_policy: str = "sync"
    # 'flat' (every selected client uploads to the cloud) | 'hierarchical'
    # (clients grouped into ``edge_count`` edges; fed/hierarchy.py).
    topology: str = "flat"
    # E — number of edge groups; required (> 0) when topology='hierarchical'.
    edge_count: int = 0
    # Per-edge inner selection budget m_e. 0 ⇒ distribute ``num_selected``
    # across edges proportionally to edge size (budgets then sum to ≤ m).
    edge_budget: int = 0

    @property
    def num_selected(self) -> int:
        return max(int(round(self.participation * self.num_clients)), 1)
