"""Configuration dataclasses (the port's own copy of grasp_tpu/configs.py).

The fields, defaults and preset constructors equal the JAX package's, so a
``ModelConfig`` serialises to the same JSON in both and ``grasp_meta.json``
reads both ways; a test pins that. Fields that name a TPU feature keep their
name here: ``use_flash_attention`` selects the CUDA flash-attention kernels,
``use_pallas_lowrank`` is not ported yet.

Replaces the reference's two-stage env-var + argparse config system
(reference: scripts/params_script.sh:1-53 expanded into grasp.py:155-244 flags)
with typed dataclasses. Defaults encode the paper's published config
(NUM_PRUNE_LAYERS=7, COMPRESSION_RATIO=0.9, METRIC=taylor, NUM_SAMPLES=512,
SEQ_LEN=512 — reference scripts/params_script.sh:10-27).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture of a LLaMA-family causal LM (GQA supported for Mistral).

    Field semantics follow HF LlamaConfig so weights can be imported 1:1.
    """

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32          # < num_attention_heads => GQA (Mistral)
    head_dim: Optional[int] = None          # default hidden_size // num_attention_heads
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    attention_bias: bool = False            # qkvo projection bias (Qwen-style)
    mlp_bias: bool = False
    hidden_act: str = "silu"                # MLP gate activation (HF ACT2FN name);
    #                                         "gelu_pytorch_tanh" for Gemma's GeGLU
    norm_plus_one: bool = False             # RMSNorm scales by (1 + w) (Gemma; w zero-init)
    scale_embeddings: bool = False          # h0 = embed * sqrt(hidden_size) (Gemma)
    sliding_window: Optional[int] = None    # windowed causal attention (Mistral):
    #                                         query i sees keys (i-w, i]; None = full
    rope_scaling: Optional[Any] = None      # HF rope_scaling dict ("llama3"/"linear");
    #                                         normalized to sorted (k, v) tuple pairs so
    #                                         the (frozen) config stays hashable for jit
    #                                         static args (eval/ppl.py)
    # Gemma-2 family:
    layer_types: Optional[Tuple[str, ...]] = None  # per-layer "sliding_attention" /
    #                                         "full_attention"; None = sliding_window
    #                                         (if any) applies to every layer
    attn_logit_softcapping: Optional[float] = None  # scores = c*tanh(scores/c) pre-mask
    final_logit_softcapping: Optional[float] = None  # same cap on the lm logits
    query_pre_attn_scalar: Optional[float] = None    # attn scale = qpas**-0.5 (else hd**-0.5)
    sandwich_norms: bool = False            # Gemma-2 layer: norms around BOTH the
    #                                         attention output and the MLP (4 per layer)
    dtype: str = "float32"                  # parameter dtype ("float32" | "bfloat16")
    use_pallas_lowrank: bool = False        # fused VMEM low-rank kernel for big-batch calls
    use_flash_attention: bool = False       # Pallas flash attention on full-sequence causal paths
    # Mixture-of-Experts (Mixtral-family): 0 => dense MLP. When > 0 every
    # layer's MLP is a sparse MoE block (router + num_local_experts SwiGLU
    # experts, top num_experts_per_tok per token) — models/moe.py.
    num_local_experts: int = 0
    num_experts_per_tok: int = 2

    def __post_init__(self):
        # normalize rope_scaling (dict from HF / list-of-pairs from JSON)
        # into sorted tuple pairs: frozen dataclass stays hashable
        rs = self.rope_scaling
        if rs is not None and not isinstance(rs, tuple):
            items = rs.items() if isinstance(rs, dict) else rs
            object.__setattr__(
                self, "rope_scaling",
                tuple(sorted(
                    (str(k), tuple(v) if isinstance(v, (list, tuple)) else v)
                    for k, v in items)))  # longrope factor LISTS stay hashable
        if self.layer_types is not None and not isinstance(self.layer_types, tuple):
            object.__setattr__(self, "layer_types", tuple(self.layer_types))

    def layer_window(self, layer_idx: int) -> Optional[int]:
        """The sliding window layer `layer_idx` attends with (None = full).

        Uniform-window families (Mistral) window every layer; Gemma-2's
        layer_types alternates sliding and full layers."""
        if self.sliding_window is None:
            return None
        if self.layer_types is None:
            return self.sliding_window
        return (self.sliding_window
                if self.layer_types[layer_idx] == "sliding_attention" else None)

    @property
    def rope_scaling_dict(self) -> Optional[dict]:
        return dict(self.rope_scaling) if self.rope_scaling else None

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @property
    def kv_dim(self) -> int:
        return self.num_key_value_heads * self.head_dim_

    @property
    def q_dim(self) -> int:
        return self.num_attention_heads * self.head_dim_

    @staticmethod
    def tiny(**overrides) -> "ModelConfig":
        """A small config for tests — exercises GQA & non-square projections."""
        base = dict(
            vocab_size=256,
            hidden_size=64,
            intermediate_size=176,
            num_hidden_layers=4,
            num_attention_heads=4,
            num_key_value_heads=2,
            max_position_embeddings=256,
        )
        base.update(overrides)
        return ModelConfig(**base)

    @staticmethod
    def tinyllama_1_1b() -> "ModelConfig":
        return ModelConfig(
            vocab_size=32000,
            hidden_size=2048,
            intermediate_size=5632,
            num_hidden_layers=22,
            num_attention_heads=32,
            num_key_value_heads=4,
            max_position_embeddings=2048,
        )

    @staticmethod
    def llama2_7b() -> "ModelConfig":
        return ModelConfig()

    @staticmethod
    def phi3_mini_4k() -> "ModelConfig":
        """Phi-3-mini-4k (3.8B): MHA at head_dim 96, fused qkv/gate_up in HF
        checkpoints (split exactly on ingest, models/hf_io.py)."""
        return ModelConfig(
            vocab_size=32064,
            hidden_size=3072,
            intermediate_size=8192,
            num_hidden_layers=32,
            num_attention_heads=32,
            num_key_value_heads=32,
            max_position_embeddings=4096,
            rope_theta=10000.0,
            rms_norm_eps=1e-5,
        )

    @staticmethod
    def qwen2_7b() -> "ModelConfig":
        """Qwen2-style: GQA + qkv projection biases (attention_bias=True)."""
        return ModelConfig(
            vocab_size=152064,
            hidden_size=3584,
            intermediate_size=18944,
            num_hidden_layers=28,
            num_attention_heads=28,
            num_key_value_heads=4,
            max_position_embeddings=32768,
            rope_theta=1000000.0,
            rms_norm_eps=1e-6,
            attention_bias=True,
        )

    @staticmethod
    def mixtral_8x7b() -> "ModelConfig":
        """Mixtral-family sparse MoE (8 SwiGLU experts, top-2 routing)."""
        return ModelConfig(
            vocab_size=32000,
            hidden_size=4096,
            intermediate_size=14336,
            num_hidden_layers=32,
            num_attention_heads=32,
            num_key_value_heads=8,
            max_position_embeddings=32768,
            rope_theta=1000000.0,
            num_local_experts=8,
            num_experts_per_tok=2,
        )

    @staticmethod
    def llama3_8b() -> "ModelConfig":
        """LLaMA-3 8B: GQA (8 KV heads), 128k vocab, rope theta 5e5."""
        return ModelConfig(
            vocab_size=128256,
            hidden_size=4096,
            intermediate_size=14336,
            num_hidden_layers=32,
            num_attention_heads=32,
            num_key_value_heads=8,
            max_position_embeddings=8192,
            rope_theta=500000.0,
            rms_norm_eps=1e-5,
        )

    @staticmethod
    def llama3_1_8b() -> "ModelConfig":
        """LLaMA-3.1 8B: the 3.0 architecture + llama3 rope scaling to 128k."""
        return ModelConfig(
            vocab_size=128256,
            hidden_size=4096,
            intermediate_size=14336,
            num_hidden_layers=32,
            num_attention_heads=32,
            num_key_value_heads=8,
            max_position_embeddings=131072,
            rope_theta=500000.0,
            rms_norm_eps=1e-5,
            rope_scaling={
                "rope_type": "llama3",
                "factor": 8.0,
                "low_freq_factor": 1.0,
                "high_freq_factor": 4.0,
                "original_max_position_embeddings": 8192,
            },
        )

    @staticmethod
    def gemma2_9b() -> "ModelConfig":
        """Gemma-2 9B: Gemma-1's GeGLU/(1+w)-norm/scaled-embed/tied-head plus
        sandwich norms, attn+final logit softcapping, query_pre_attn_scalar
        attention scaling, and alternating sliding/full attention layers."""
        return ModelConfig(
            vocab_size=256000,
            hidden_size=3584,
            intermediate_size=14336,
            num_hidden_layers=42,
            num_attention_heads=16,
            num_key_value_heads=8,
            head_dim=256,
            max_position_embeddings=8192,
            rope_theta=10000.0,
            rms_norm_eps=1e-6,
            tie_word_embeddings=True,
            hidden_act="gelu_pytorch_tanh",
            norm_plus_one=True,
            scale_embeddings=True,
            sliding_window=4096,
            layer_types=tuple(
                "sliding_attention" if i % 2 == 0 else "full_attention"
                for i in range(42)),
            attn_logit_softcapping=50.0,
            final_logit_softcapping=30.0,
            query_pre_attn_scalar=256.0,
            sandwich_norms=True,
        )

    @staticmethod
    def gemma_7b() -> "ModelConfig":
        """Gemma-1 7B: GeGLU MLP, (1+w) RMSNorm, sqrt(hidden) embedding
        scaling, tied lm_head, decoupled head_dim (16 x 256 = 4096 != 3072
        hidden, so o_proj is 4096 -> 3072)."""
        return ModelConfig(
            vocab_size=256000,
            hidden_size=3072,
            intermediate_size=24576,
            num_hidden_layers=28,
            num_attention_heads=16,
            num_key_value_heads=16,
            head_dim=256,
            max_position_embeddings=8192,
            rope_theta=10000.0,
            rms_norm_eps=1e-6,
            tie_word_embeddings=True,
            hidden_act="gelu_pytorch_tanh",
            norm_plus_one=True,
            scale_embeddings=True,
        )

    @staticmethod
    def gemma_2b() -> "ModelConfig":
        """Gemma-1 2B: MQA (1 KV head), otherwise the 7B's architecture."""
        return ModelConfig(
            vocab_size=256000,
            hidden_size=2048,
            intermediate_size=16384,
            num_hidden_layers=18,
            num_attention_heads=8,
            num_key_value_heads=1,
            head_dim=256,
            max_position_embeddings=8192,
            rope_theta=10000.0,
            rms_norm_eps=1e-6,
            tie_word_embeddings=True,
            hidden_act="gelu_pytorch_tanh",
            norm_plus_one=True,
            scale_embeddings=True,
        )

    @staticmethod
    def mistral_7b() -> "ModelConfig":
        return ModelConfig(
            vocab_size=32000,
            hidden_size=4096,
            intermediate_size=14336,
            num_hidden_layers=32,
            num_attention_heads=32,
            num_key_value_heads=8,
            max_position_embeddings=32768,
            rope_theta=10000.0,
            sliding_window=4096,
        )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(s: str) -> "ModelConfig":
        return ModelConfig(**json.loads(s))


# Default projection targets (reference modeling_grasp.py:248, grasp.py:34-35).
ATTN_TARGETS: Tuple[str, ...] = ("q_proj", "k_proj", "v_proj", "o_proj")
MLP_TARGETS: Tuple[str, ...] = ("down_proj", "up_proj", "gate_proj")


@dataclass
class GraspConfig:
    """Full compression-pipeline configuration (reference grasp.py:29-49 args)."""

    model_name_or_path: str = ""
    dataset_name: str = "wikitext2"

    # which layers to compress
    layers_id: Optional[List[int]] = None
    num_prune_layers: Optional[int] = 7
    angular: bool = False

    # per-block projection targets
    mlp_target_layer_types: Tuple[str, ...] = MLP_TARGETS
    attn_target_layer_types: Tuple[str, ...] = ATTN_TARGETS

    # rank selection
    metric: str = "taylor"                  # "gradient" | "taylor"
    compression_ratio: Optional[float] = 0.9
    threshold_ratio: Optional[float] = None  # adaptive selection if set
    merge: bool = False                      # re-materialize dense instead of low-rank
    sigma_fuse: str = "UV"                   # "UV" | "U"  (ref "V" branch is buggy; rejected)

    # calibration data
    num_samples: int = 512
    batch_size: int = 1
    seq_len: int = 512
    seed: int = 42

    # sweep strategy: "sequential" reproduces the reference's per-(layer, block)
    # calibration re-sweeps (grasp.py:79-126); "parallel" SVD-ifies every target
    # projection of every redundant layer at once and collects all S-gradients in
    # ONE calibration sweep (TPU-friendly fast path).
    sweep: str = "sequential"

    # parallel-mode HBM guard: one dense-grad sweep over ALL redundant layers
    # keeps a kernel-sized grad accumulator per target module resident (at the
    # 7B paper config: 49 modules, ~2.8 GiB bf16 — which next to 12.55 GiB of
    # params and the sweep graph's ~1.3 GiB working set exceeds the 16 GB
    # chip). sweep_chunk_layers bounds residency by sweeping the redundant
    # layers (descending) in groups of N layers, selecting+compiling each
    # group before the next sweeps — each extra chunk costs one more
    # calibration sweep. None = auto (engine._auto_sweep_chunk: one chunk
    # whenever the accumulators fit next to live params, else the largest N
    # that fits); 0 = force a single sweep. Chunks only tighten semantics
    # toward sequential mode (later chunks see earlier compressions).
    sweep_chunk_layers: Optional[int] = None

    # gradient collection: "dense" differentiates w.r.t. the dense kernels and
    # projects onto singular directions (dL/ds_i = u_i^T dL/dW v_i) — the host
    # SVD overlaps the TPU sweep and the model is untouched during gradient
    # collection (fewer recompiles). "svd" is the reference-literal path
    # (swap in full-SVD modules with trainable S first). Selected indices are
    # identical (validated in tests/test_engine_golden.py).
    grad_mode: str = "dense"

    # prefix split for sequential dense sweeps: layers below the lowest
    # redundant layer are NEVER modified across rounds, so each round's grad
    # graph can start at that boundary — a prefix forward compiled ONCE serves
    # every round, and per-round grad graphs cover only the compressed tail
    # (at 7B: 7 of 32 layers). Values: "off" (monolithic graphs, the
    # reference-literal shape), "recompute" (prefix re-run per batch per
    # round — saves compile time only), "cache" (prefix activations computed
    # once and kept on device — also saves the prefix FLOPs every round),
    # "cache_host" (like "cache" — same FLOP win — but parked in host RAM
    # and re-uploaded per use, for 7B scale where the boundary set [batches
    # x B x S x hidden bf16, 2.14 GiB at the paper config] doesn't fit next
    # to the sweep's HBM peak; the bf16 round trip is bit-exact), "auto"
    # (when the split saves >= 4 layers: cache if the boundary set fits
    # device HBM, else cache_host if it fits host RAM, else recompute —
    # engine._choose_prefix_cache; otherwise off).
    # Identical results: the prefix computes the same values every round
    # (pinned by tests/test_engine_prefix.py).
    prefix: str = "auto"

    # recovery (GRASP*)
    recovery: bool = False
    data_path: str = "yahma/alpaca-cleaned"
    train_batch_size: int = 32
    micro_batch_size: int = 4
    num_epochs: int = 1
    learning_rate: float = 3e-4
    max_length: int = 256
    val_set_size: int = 2000
    train_on_inputs: bool = True
    add_eos_token: bool = False
    prompt_template_name: str = "alpaca"

    # evaluation
    evaluate: bool = False
    eval_ppl: str = "wikitext2,ptb,c4"
    eval_tasks: str = "boolq,piqa,hellaswag,winogrande,arc_easy,arc_challenge,openbookqa,mathqa"
    num_fewshot: int = 0
    limit: int = -1

    # runtime
    save_path: Optional[str] = None
    verbose: bool = False
    log_file: Optional[str] = None

    # mesh / sharding
    mesh_shape: Optional[Tuple[int, int]] = None   # (data, model); None => single device
    param_dtype: str = "float32"
    remat: bool = False                            # jax.checkpoint per transformer layer

    extra: dict = field(default_factory=dict)
