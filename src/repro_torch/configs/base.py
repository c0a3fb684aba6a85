"""Config system: model configs, input-shape configs, run configs.

A copy of ``repro.configs.base`` (pure data), kept here so the PyTorch
port imports nothing of the JAX package. Fields the port does not read yet
(``use_pallas``, ``remat``, the checkpoint and topology knobs) stay so the
two packages describe one run with the same values.

Every assigned architecture is a frozen ``ModelConfig``; the four assigned
input shapes are ``ShapeConfig`` instances. ``RunConfig`` binds a model, a
shape, a mesh layout and the fault-tolerance policy (the paper's technique)
into one launchable unit.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters for every supported family.

    family:
      dense  - decoder-only transformer (GQA / qk-norm / bias feature flags)
      moe    - dense backbone with MoE FFN (top-k routing)
      ssm    - xLSTM (sLSTM + mLSTM blocks)
      hybrid - Mamba2 backbone with shared attention blocks (Zamba2)
      audio  - encoder/decoder transformer, stub conv frontend (Whisper)
      vlm    - decoder with interleaved cross-attention image layers
    """

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads

    # --- dense feature flags -------------------------------------------------
    qk_norm: bool = False             # qwen3
    qkv_bias: bool = False            # qwen1.5
    attn_out_bias: bool = False
    sliding_window: int = 0           # 0 -> full attention (mixtral: 4096)
    rope_theta: float = 1e4
    tie_embeddings: bool = False

    # --- MoE -----------------------------------------------------------------
    n_experts: int = 0
    n_experts_per_tok: int = 0
    capacity_factor: float = 1.25

    # --- SSM / hybrid --------------------------------------------------------
    ssm_state: int = 0                # mamba2 state dim (zamba2: 64)
    ssm_chunk: int = 128              # mamba2 chunked-scan chunk length
    attn_every: int = 0               # hybrid: shared attn block cadence
    slstm_every: int = 0              # xlstm: every k-th block is sLSTM
    conv_kernel: int = 4              # mamba2 depthwise conv width
    expand: int = 2                   # mamba2 expansion factor

    # --- encoder-decoder (audio) ---------------------------------------------
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    n_frames: int = 1500              # whisper stub frontend output length

    # --- vlm -----------------------------------------------------------------
    cross_attn_every: int = 0         # insert a cross-attn layer every k layers
    n_image_tokens: int = 0

    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def is_subquadratic(self) -> bool:
        """Can this arch serve a 500k-token context (long_500k shape)?"""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0

    @property
    def supports_decode(self) -> bool:
        return True  # no encoder-only archs are assigned

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND roofline MODEL_FLOPS)."""
        from repro_torch.models import api
        return api.param_count(self)

    def active_param_count(self) -> int:
        from repro_torch.models import api
        return api.param_count(self, active_only=True)

    def reduced(self) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        small = dict(
            n_layers=min(self.n_layers, 4 if self.attn_every == 0 else 2 * max(1, self.attn_every)),
            d_model=128,
            n_heads=4,
            n_kv_heads=max(1, min(4, 4 * self.n_kv_heads // max(self.n_heads, 1))),
            d_ff=0 if self.d_ff == 0 else 256,
            vocab_size=512,
            head_dim=32,
            n_experts=min(self.n_experts, 4),
            n_experts_per_tok=min(self.n_experts_per_tok, 2),
            sliding_window=64 if self.sliding_window else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_chunk=16,
            attn_every=min(self.attn_every, 3) if self.attn_every else 0,
            slstm_every=min(self.slstm_every, 2) if self.slstm_every else 0,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            n_frames=32 if self.is_encoder_decoder else self.n_frames,
            cross_attn_every=min(self.cross_attn_every, 2) if self.cross_attn_every else 0,
            n_image_tokens=16 if self.n_image_tokens else 0,
        )
        if self.attn_every:
            # hybrid: keep a small multiple of the attention cadence
            small["n_layers"] = 2 * small["attn_every"] + 1
        return dataclasses.replace(self, **small)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape. kind selects which step gets lowered."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch          # one new token per sequence
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", seq_len=4096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32768, global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32768, global_batch=128, kind="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524288, global_batch=1, kind="decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


@dataclass(frozen=True)
class MeshConfig:
    """Logical mesh layout. The production meshes are fixed by the spec."""

    shape: tuple = (16, 16)
    axes: tuple = ("data", "model")

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def batch_axes(self) -> tuple:
        return tuple(a for a in self.axes if a in ("pod", "data"))


SINGLE_POD = MeshConfig((16, 16), ("data", "model"))
MULTI_POD = MeshConfig((2, 16, 16), ("pod", "data", "model"))


@dataclass(frozen=True)
class FTConfig:
    """Fault-tolerance policy — the paper's knobs.

    mode:
      none        - native step loop, no fault tolerance
      checkpoint  - coordinated checkpoint/restart only (paper baseline)
      replication - replication only (paper's headline result)
      combined    - checkpoint/restart + replication (paper's unified framework)
    """

    mode: str = "combined"
    replication_degree: float = 1.0      # M/N, partial replication supported
    mtbf_s: float = 2000.0               # per-job MTBF for the failure model
    ckpt_cost_s: float = 0.0             # measured C; 0 -> measure online
    ckpt_interval_s: float = 0.0         # 0 -> Young-Daly sqrt(2*mu*C)
    # checkpoint durability backend (repro.store.make_backend):
    #   disk   - checkpoint/io.py Checkpointer (falls back to the memory
    #            store when there is no ckpt_dir / non-disk workload)
    #   memory - replicated in-memory store: shards pushed to store_partners
    #            partner memories in store_bands messages (network-bound C)
    ckpt_backend: str = "disk"
    store_partners: int = 2
    store_bands: int = 4
    # cluster topology + α‑β message pricing (repro.topo). None keeps the
    # flat-constant cost model; "flat" | "fattree" | "dragonfly" |
    # "torus3d" builds a TopoGraph over the runtime's nodes, prices every
    # transport message at topo_alpha·hops + size/topo_beta +
    # topo_gamma·size, and switches the collective registry to the
    # MPICH-style tree/ring algorithm selection (threshold topo_small_msg).
    topology: Optional[str] = None
    topo_alpha: float = 100e-6           # s per hop
    topo_beta: float = 12.5e9            # bytes/s per link
    topo_gamma: float = 0.0              # s per byte processing overhead
    topo_small_msg: int = 8192           # bytes; selection threshold
    weibull_shape: float = 0.7           # paper: matches real failure traces
    message_log_limit_bytes: int = 1 << 28
    # hand every p2p recv a private writeable copy instead of the shared
    # frozen (read-only) payload — for apps that mutate received buffers
    # in place, legal under real MPI (docs/comm_api.md migration notes).
    # Costs one structural_copy per recv.
    mutable_recv: bool = False
    max_failures: int = 0                # 0 -> unbounded
    seed: int = 0


@dataclass
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig = SINGLE_POD
    ft: FTConfig = field(default_factory=FTConfig)
    # replication mapping: "none" | "pod" | "split"  (DESIGN.md section 4)
    replication_axis: str = "none"
    remat: str = "full"                  # "none" | "full" | "dots"
    use_pallas: bool = False             # TPU path; CPU dry-run uses jnp path
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    seq_chunk: int = 2048                # cross-entropy / logit chunking
    kv_block: int = 512                  # blockwise-attention KV tile
