"""Model/run configuration — the F1 layer.

Like hlslib's CMake integration, configuration is fully separated from
source: every assigned architecture is a frozen ``ModelConfig`` in its
own module, selectable by ``--arch <id>``; input shapes are ``ShapeCfg``
entries.  Nothing in ``src/repro/models`` hard-codes an architecture.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..core import datapack

MODEL_AXIS = 16  # model-parallel shard count of the production mesh


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int             # logical vocab (padding applied via DataPack)
    head_dim: int = 128

    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    rope_theta_global: float = 1e6     # gemma3 global layers
    sliding_window: Optional[int] = None
    local_global_pattern: int = 0      # N local layers per 1 global (gemma3)

    # MLA (deepseek)
    mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 64

    # hybrid (zamba2): apply the single shared attention block after every
    # ``shared_attn_every``-th mamba layer.
    shared_attn_every: int = 0

    # multimodal stubs
    vision_patches: int = 0
    vision_dim: int = 0
    n_codebooks: int = 0
    cross_attention: bool = False
    cond_len: int = 0

    mlp_gated: bool = True            # SwiGLU vs plain GELU MLP

    # numerics / implementation
    dtype: str = "bfloat16"
    use_pallas: bool = False
    remat: str = "dots"               # none | dots | full
    attn_block_q: int = 512
    attn_block_k: int = 512
    attn_block_skip: bool = False     # beyond-paper: skip masked blocks
    attn_head_constraints: bool = True  # explicit head sharding (divisible only)
    fuse_qkv: bool = False            # beyond-paper: single QKV matmul
    attn_p_bf16: bool = False         # beyond-paper: bf16 probs into PV matmul
    moe_groups: int = 0               # beyond-paper: grouped dispatch (DPxEP)
    decode_seq_shard: bool = False    # beyond-paper: shard decode KV over seq
    decode_flash: bool = False        # beyond-paper: sq=1 flash decode kernel
    kv_cache_dtype: str = "bfloat16"  # beyond-paper: "int8" quantized KV
    # paged serving (continuous batcher): page-pool KV with per-slot block
    # tables, pluggable per attention family via models.cache_layouts
    # (flat GQA, gemma3 local/global ring-of-pages, MLA latent pages,
    # int8 pages with per-position scales).  0 = dense slot caches.
    # Recurrent families (ssm/hybrid) have O(1)/slot state — nothing to
    # page — and always use the dense path.
    kv_page_size: int = 0
    prefill_chunk: int = 0            # chunked-prefill chunk tokens (0 = auto)
    prefill_interleave: int = 1       # decode steps between prefill chunks
    # prefix cache (paged mode only): retired prompts linger as shared
    # pages in a radix-tree PrefixIndex; a later request with the same
    # prompt prefix attaches those pages (refcounted, copy-on-write past
    # the divergence point) and skips prefill for the matched span.
    # Requires every page group of the layout to be shareable (flat
    # GQA / MLA latent / int8+scales are; gemma3's ring local group is
    # not, so gemma3 silently keeps exclusive pages).
    prefix_cache: bool = False
    prefix_block: int = 0             # match granularity tokens (0 = page)
    # chunked-prefill exactness: the FINAL chunk recomputes the whole
    # remaining prompt span in one full-precision pass (pow2-bucketed
    # shape), so the installed K/V — and hence every later decode read —
    # is bit-identical to a single dense prefill regardless of how the
    # prompt was chunked.  Costs up to one extra prefill of FLOPs; the
    # intermediate chunks still run so decode interleaving keeps its
    # latency bound.
    prefill_exact: bool = False
    # tiered KV memory (serve.kv_tiers; needs prefix_cache): byte budget
    # of the host-RAM tier (T1) that prefix-cache eviction demotes page
    # payloads into — a later rehit restores the pages (one staged
    # host->device transfer + catch-up chunk) instead of recomputing
    # prefill.  0 disables the tier (eviction drops the bytes).
    kv_host_tier_bytes: int = 0
    # optional on-disk snapshot (T2) of the host tier: loaded at batcher
    # construction if the file exists; ContinuousBatcher.save_tier_
    # snapshot() flushes the live index + T1 store back to it, so cached
    # system prompts survive batcher restarts.  "" disables.
    kv_tier_snapshot: str = ""
    # recompute-vs-restore policy: spans shorter than this many tokens
    # are recomputed from tokens instead of staged through host RAM — a
    # T1 rehit below the knob falls through to plain prefill, and a
    # preempted sequence below it parks as a recompute record
    # (re-admission + suppressed-output decode replay) instead of
    # spilling pages.  Only active in tiered mode (kv_host_tier_bytes >
    # 0); the default sits at the measured restore/recompute TTFT
    # crossover of the host_tier_rehit bench (restore wins from roughly
    # two chunks of tokens upward).
    tier_restore_min_tokens: int = 32
    # reserve decode pages up-front at admission (plen + max_new) instead
    # of the default lazy growth (prompt pages only; decode pages are
    # allocated on demand, preempting the lowest-priority slot when the
    # pool runs dry).  Kept as a knob for A/B benchmarking.
    kv_reserve_decode: bool = False
    # -- resilient serving (serve.resilience) --------------------------------------
    # admission order: "fifo" (arrival order) or "sla" (SLA class rank,
    # then deadline, then arrival; batch-class work whose deadline the
    # projected queue delay already blows is load-shed with a typed
    # rejection).
    serve_schedule: str = "fifo"
    # full-request-queue policy: "block" backpressures the producer
    # (bounded-FIFO semantics); "reject" sheds with a typed `queue_full`
    # rejection and submit() returns False.
    serve_overload: str = "block"
    # request queue depth (0 = the 2*n_slots default).
    serve_queue_depth: int = 0
    # deterministic fault-injection spec ("" = off); grammar
    # "site:N|N+|N..M|*[@p]" joined with ";" — see
    # serve.resilience.FaultPlan.  Overridable via the REPRO_FAULTS env
    # var (and REPRO_FAULT_SEED for the @p probability draws).
    fault_plan: str = ""
    # -- speculative decode (paged mode only) --------------------------------------
    # k-token self-speculative decode: an n-gram drafter proposes up to
    # speculate_k tokens per slot from the slot's own history; ONE
    # (k+1)-length verify call (mode="verify") scores the whole span
    # (last committed token + drafts), and
    # accepted tokens commit while rejected tails roll back by
    # block-table swap (speculative KV lands in private scratch pages —
    # never in shared/refcounted ones).  Output stays bit-identical to
    # non-speculative greedy decode.  0 disables speculation.  NOTE:
    # speculate_k also pads gemma3's ring table width (the verify span
    # may clobber up to speculate_k extra ring positions), so it must be
    # set at batcher construction, not toggled mid-flight.
    speculate_k: int = 0
    # history context the drafter requires: the trailing speculate_ngram
    # tokens must ALL reappear earlier in the slot's history (prompt +
    # generated) for a draft to fire.  Shorter matches are never used —
    # on novel text they are single-token coincidences whose rejected
    # drafts each cost a verify round.
    speculate_ngram: int = 3
    # per-slot acceptance-rate EWMA floor: a slot whose acceptance drops
    # below this stops drafting (adversarial/low-entropy-free workloads
    # then pay only the plain decode path).
    speculate_min_accept: float = 0.3
    # a self-disabled slot re-probes (drafts anyway) every Nth batcher
    # step: text that turns repetitive mid-request (code, tables, greedy
    # cycles) re-enables speculation via the EWMA instead of staying
    # disabled forever.  0 makes the disable sticky for the request.
    speculate_probe: int = 16
    # -- mesh-sharded serving (serve.serve_loop / serve.batching) -------------------
    # device mesh for the paged serving steps: () = single device (the
    # shard_map path is skipped entirely).  Rank keys the axis names —
    # (model,), (data, model), (pod, data, model) — and the LAST entry
    # is the tensor-parallel extent: KV page pools shard over the
    # head/latent axis per CacheLayout group, block tables and slot
    # state stay replicated, and the decode/prefill/verify step bodies
    # run under jax.shard_map with a psum at every attention/FF output
    # projection and an all_gather at the MLA latent read and the
    # logits.  Token streams are bit-identical to the 1-device path for
    # float32 smoke configs (column-sharded matmuls reduce over the
    # UNSHARDED contraction dim, so per-shard partials sum in a fixed
    # axis-index order).  Validate with
    # distributed.sharding.validate_shardable before building a batcher.
    mesh_shape: Tuple[int, ...] = ()
    # mesh axis the model (tensor-parallel) dims shard over; must name
    # the last axis of mesh_shape.
    tp_axis: str = "model"
    embed_std: float = 0.02

    # -- derived -----------------------------------------------------------------

    @property
    def padded_vocab(self) -> int:
        return datapack.padded_vocab(self.vocab_size, MODEL_AXIS)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_headdim else 0

    @property
    def group_layout(self) -> Tuple[int, int]:
        """(n_groups, layers_per_group) for the scan-over-groups layout."""
        if self.local_global_pattern:
            per = self.local_global_pattern + 1
            assert self.n_layers % per == 0
            return self.n_layers // per, per
        return self.n_layers, 1

    def param_count_dense(self) -> int:
        """Rough N for MODEL_FLOPS = 6·N·D bookkeeping (see roofline)."""
        from ..models import registry
        return registry.num_params(self)


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                    # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCfg("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCfg("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCfg("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCfg("long_500k", "decode", 524_288, 1),
}

# Archs for which long_500k runs (sub-quadratic path exists); see DESIGN §7.
LONG_CONTEXT_ARCHS = ("mamba2-1p3b", "zamba2-1p2b", "gemma3-12b")


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: few layers, narrow
    width, tiny vocab — per the assignment's smoke-test requirement."""
    per = cfg.local_global_pattern + 1 if cfg.local_global_pattern else 1
    n_layers = max(2 * per, cfg.shared_attn_every + 1
                   if cfg.shared_attn_every else 0)
    if cfg.shared_attn_every:
        n_layers = 2 * cfg.shared_attn_every
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        sliding_window=16 if cfg.sliding_window else None,
        kv_lora_rank=32 if cfg.mla else 0,
        qk_nope_dim=32 if cfg.mla else 0,
        qk_rope_dim=16 if cfg.mla else 0,
        v_head_dim=32 if cfg.mla else 0,
        n_experts=4 if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_headdim=16 if cfg.ssm_state else 64,
        ssm_chunk=8 if cfg.ssm_state else 64,
        vision_dim=64 if cfg.vision_dim else 0,
        vision_patches=8 if cfg.vision_patches else 0,
        cond_len=8 if cfg.cond_len else 0,
        dtype="float32",
        remat="none",
    )
    return dataclasses.replace(cfg, **kw)
