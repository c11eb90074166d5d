"""Model and optimizer configs: the fields of the reference's
`repro/configs/base.py` that this port reads, as its own copy.

`reduced()` derives the CPU-scale variant of the same family exactly as the
reference does, so a reduced config here and there describes the same model.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0           # routed experts
    n_shared: int = 0            # shared (always-on) experts
    top_k: int = 2
    d_expert: int = 0            # per-expert FFN hidden size
    capacity_factor: float = 1.25
    # layers [0, dense_prefix) use a dense FFN instead of MoE (DeepSeek-V2
    # keeps the first block dense): the "dense_blocks" stack
    dense_prefix: int = 1
    router_aux_weight: float = 0.001


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16            # recurrent state per channel (Mamba) / head
    d_conv: int = 4              # depthwise conv width (Mamba)
    expand: int = 2              # inner expansion for Mamba
    head_dim: int = 64           # RWKV6 head size


@dataclass(frozen=True)
class ModelConfig:
    name: str
    # dense | encoder | moe | ssm (rwkv6) | hybrid | audio (enc-dec) | vlm
    arch_type: str
    source: str                  # citation for the numbers
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None       # default d_model // n_heads
    max_seq_len: int = 8192
    attention: str = "gqa"               # gqa | swa | mla | none
    window: Optional[int] = None         # sliding-window size for swa
    # MLA (MiniCPM3): the q and kv low-rank projections and head sizes
    q_lora_rank: Optional[int] = None
    kv_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: Optional[int] = None
    moe: Optional[MoEConfig] = None      # routed experts (DeepSeek-V2)
    ssm: Optional[SSMConfig] = None      # rwkv6's head size; hybrid's Mamba
    # encoder-decoder (whisper): num_layers = decoder layers
    encoder_layers: int = 0
    encoder_seq_len: int = 1500          # whisper frames after the conv stub
    # vlm: the number of stub patch embeddings prepended to the text
    n_patch_tokens: int = 0
    norm: str = "rmsnorm"                # rmsnorm | layernorm
    act: str = "silu"                    # silu (gated MLP) | gelu (plain MLP)
    pos_emb: str = "rope"                # rope | sinusoidal (added at embed)
    rope_theta: float = 10000.0
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads

    @property
    def resolved_v_head_dim(self) -> int:
        if self.v_head_dim is not None:
            return self.v_head_dim
        return self.resolved_head_dim

    def padded_vocab(self, tp: int = 1) -> int:
        mult = 128 * max(tp, 1)
        return ((self.vocab_size + mult - 1) // mult) * mult

    def reduced(self) -> "ModelConfig":
        """CPU-smoke variant of the same family (<=2 layers, d_model<=256;
        mla's ranks and head sizes cut and its q low-rank projection
        dropped; swa's window 64; MoE at 4 experts of 128, top-2, at most
        one shared expert and one dense layer; an enc-dec model at one
        encoder and one decoder layer over 64 frames; a vlm at 16 patch
        tokens). `ssm` is kept: head_dim 32 is the attention head size, an rwkv6 model keeps ssm.head_dim 64 (4
        heads at d_model 256), and a hybrid model's Mamba heads keep their
        state, conv width and expansion (d_inner 512 at d_model 256)."""
        d_model = min(self.d_model, 256)
        n_heads = max(2, min(self.n_heads, 4))
        ratio = max(1, self.n_heads // max(self.n_kv_heads, 1))
        n_kv = max(1, n_heads // min(ratio, n_heads))
        kw = dict(
            num_layers=min(self.num_layers, 2),
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=32,
            d_ff=min(self.d_ff, 448),
            vocab_size=min(self.vocab_size, 512),
            max_seq_len=min(self.max_seq_len, 256),
            name=self.name + "-reduced",
        )
        if self.attention == "mla":
            kw.update(q_lora_rank=None, kv_lora_rank=64,
                      qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32)
        if self.window is not None:
            kw.update(window=64)
        if self.moe is not None:
            kw["moe"] = replace(self.moe, n_experts=4,
                                n_shared=min(self.moe.n_shared, 1), top_k=2,
                                d_expert=128,
                                dense_prefix=min(self.moe.dense_prefix, 1))
        if self.encoder_layers:
            kw.update(encoder_layers=1, num_layers=1, encoder_seq_len=64)
        if self.n_patch_tokens:
            kw.update(n_patch_tokens=16)
        return replace(self, **kw)


ACCUM_ENGINES = ("ga", "adama", "adama_layerwise")
# the reference's codec names (configs/base.py), each in
# core/state_store.py's registry
STATE_CODECS = ("fp32", "int8", "factored", "rowcol")    # second moment (v)
M_CODECS = ("fp32", "int8")                              # first moment (m)
ZERO_STAGES = (0, 1)
GRAD_DTYPES = ("fp32", "bf16", "fp8_e4m3")               # gradient wire


def grad_wire_dtype(name: str):
    """The torch dtype a `grad_dtype` config value packs gradients in (the
    reference's `grad_wire_dtype`)."""
    import torch
    if name not in GRAD_DTYPES:
        raise ValueError(f"unknown grad_dtype {name!r}; expected one of "
                         f"{GRAD_DTYPES}")
    return {"bf16": torch.bfloat16,
            "fp8_e4m3": torch.float8_e4m3fn}.get(name, torch.float32)


def parse_loss_scale(value: str):
    """Parse an OptimizerConfig.loss_scale value (the reference's parser):
    "off", "dynamic", or a positive float (a static scale); ValueError
    otherwise."""
    if value in ("off", "dynamic"):
        return value
    try:
        scale = float(value)
    except (TypeError, ValueError):
        raise ValueError(
            f"loss_scale={value!r} unsupported; expected 'off', 'dynamic', "
            f"or a positive float literal (e.g. '1024')") from None
    if not (scale > 0.0):
        raise ValueError(f"loss_scale={value!r} must be > 0")
    return scale


@dataclass(frozen=True)
class OptimizerConfig:
    """The kernel paths of the reference's OptimizerConfig (use_pallas=True),
    with its m and v codecs, its gradient wire (fp32, bf16, or fp8 e4m3 with
    its error-feedback residual), its fp32 master params and bf16
    working-param cache, its finite guard and its loss-scale fields
    validated as its `optimizer_capability` does.

    `arena` selects the state form, as in the reference: True (the default
    here, the reference's `arena=True`) keeps m and v in flat arenas folded
    by the fused arena kernels; False keeps them as per-leaf trees folded
    and applied leaf by leaf (the reference's `arena=False`). The reference
    defaults to `use_pallas=False, arena=False`; the port has only kernel
    paths, and its main path is the arena."""
    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    accumulation: str = "adama"          # ga | adama | adama_layerwise
    micro_batches: int = 8
    grad_clip: Optional[float] = None
    state_codec: str = "fp32"            # second-moment codec
    m_codec: str = "fp32"                # first-moment codec
    arena: bool = True                   # False: per-leaf state
    # ZeRO-1 (the reference's P_os): with zero_stage=1 the data-parallel
    # engine (core/dp_shardmap.py) shards every row-indexed state column,
    # each rank owning 1/M of the arena's rows. Inert outside that engine,
    # as in the reference.
    zero_stage: int = 0                  # 0 | 1
    # the bucketed ZeRO-1 schedule (core/buckets.py: a reduce-scatter a
    # layer and a size-capped rest bucket, rank k owning slice k of each);
    # False: the full pack (the whole gradient arena, one reduce-scatter a
    # micro-batch, contiguous row ranges). Default True, as there
    zero_bucketed: bool = True
    # rest-region bucket cap in arena rows (0 = the reference's default)
    zero_bucket_rows: int = 0
    # the reference's double-buffered bucket pipeline (item 10.3)
    zero_async: bool = False
    # the gradient wire: the dtype each micro-batch's (or each layer's)
    # gradient is packed in (core/arena.py). "bf16" halves the packed slab;
    # the fold kernels upcast it to fp32 in-pass, so the moments still
    # accumulate in fp32. "fp8_e4m3" packs fp32 and encodes the slab as
    # e4m3 codes with a per-row fp32 scale column (kernels/fp8_wire.py),
    # which the fold kernels decode in-pass; it requires finite_guard=True
    # (e4m3 has no inf: an overflow shows as NaN codes, which the guard
    # catches). Both require arena=True and an AdamA engine (ga sums raw
    # gradients in its wire buffer).
    grad_dtype: str = "fp32"             # fp32 | bf16 | fp8_e4m3
    # the fp8 wire's error-feedback residual (inert on fp32 and bf16): each
    # fold's quantization error is kept in state["ef"], an fp32 arena in
    # unscaled gradient units, and added into the next micro-batch's
    # gradient before it is encoded. False drops the residual (the
    # reference's ablation knob): the wire still quantizes, and nothing
    # recovers the error.
    error_feedback: bool = True
    # the fused finite guard (core/accumulation.py): a micro-batch whose
    # gradient holds an Inf or a NaN folds nothing (ga: a step whose
    # accumulated gradient does applies nothing), and the skip counters
    # ride in the state ("scaler", train/scaler.py). Requires arena=True.
    finite_guard: bool = False
    # loss scaling for the gradient wire: "off" | "dynamic" | a positive
    # float literal (a static scale). The loss (adama) or the backward's
    # seed (adama_layerwise) is multiplied by the scale, and the guarded
    # fold kernels divide it back out through their traced scale; "dynamic"
    # starts at 2^15, halves on every skipped micro-batch (floor 1) and
    # doubles after scaler_growth_interval good ones (train/scaler.py).
    # Requires the bf16 or fp8 wire (the wire it protects),
    # finite_guard=True (skips drive the backoff) and an AdamA engine.
    loss_scale: str = "off"
    # good micro-batches before a dynamic scale doubles
    scaler_growth_interval: int = 200
    # train/loop.py raises after this many consecutive skipped
    # micro-batches; 0 never
    scaler_abort_after: int = 0
    # fp32 MASTER params in the arena (the AMP contract): the state gains a
    # packed fp32 region "p", which the apply kernel updates in place while
    # it writes bf16 WORKING params (bf16 of the new master) in the same
    # pass; the param leaves are refreshed from them, so they hold
    # bf16-rounded values and the fp32 truth lives in "p". Requires
    # arena=True.
    master_params: bool = False
    # the bf16 working-param cache: the state keeps the working params the
    # master apply writes as a packed bf16 region "wp" (the kernel writes
    # straight into it), and every engine loads its param leaves from it at
    # step start, so step 1 already runs on bf16-cast params. Requires
    # master_params=True.
    work_param_cache: bool = False

    def __post_init__(self):
        if self.accumulation not in ACCUM_ENGINES:
            raise ValueError(f"unknown accumulation engine "
                             f"{self.accumulation!r}; expected one of "
                             f"{ACCUM_ENGINES}")
        if self.micro_batches < 1:
            raise ValueError(f"micro_batches must be >= 1, got "
                             f"{self.micro_batches}")
        if self.state_codec not in STATE_CODECS:
            raise ValueError(f"unknown state_codec {self.state_codec!r}; "
                             f"expected one of {STATE_CODECS}")
        if self.m_codec not in M_CODECS:
            raise ValueError(f"unknown m_codec {self.m_codec!r}; expected "
                             f"one of {M_CODECS}")
        for field, name in (("state_codec", self.state_codec),
                            ("m_codec", self.m_codec)):
            if name != "fp32" and not self.arena:
                raise ValueError(f"{field}={name!r} requires arena=True: "
                                 f"codecs are columns of the flat state "
                                 f"arena (core/state_store.py)")
        self._check_zero_fields()
        self._check_wire_and_guard_fields()
        # the port's own refusals, after every check the reference makes
        if self.accumulation == "ga" and not self.arena:
            raise NotImplementedError(
                "ga with arena=False (the reference's single-device ga over "
                "per-leaf state) is not ported (ROADMAP queue 1, item 12.1: "
                "the optim/ baselines; optim/adam.py is, for the DP engine's "
                "'ga' variant); use arena=True")

    def _check_zero_fields(self):
        """The reference's checks of the ZeRO fields, in its order and with
        its messages."""
        if self.zero_stage not in ZERO_STAGES:
            raise ValueError(
                f"zero_stage={self.zero_stage} unsupported; expected one of "
                f"{ZERO_STAGES} (ZeRO-2/3 shard gradients/params, which "
                f"AdamA already makes transient)")
        if self.zero_bucket_rows < 0:
            raise ValueError(f"zero_bucket_rows must be >= 0 (0 = default "
                             f"cap), got {self.zero_bucket_rows}")
        if self.zero_async:
            if self.zero_stage != 1:
                raise ValueError(
                    "zero_async=True requires zero_stage=1: the double-"
                    "buffered pipeline overlaps per-bucket gradient "
                    "reduce-scatters against slice folds, which only exist "
                    "in the ZeRO-1 row-range schedule; pass zero_stage=1")
            if not self.arena:
                raise ValueError(
                    "zero_async=True requires arena=True (use_pallas=True): "
                    "the bucket pipeline streams slices of the flat state "
                    "arena; pass arena=True use_pallas=True")
            if not self.zero_bucketed and \
                    self.accumulation != "adama_layerwise":
                raise ValueError(
                    "zero_async=True requires the bucketed ZeRO-1 schedule "
                    "(zero_bucketed=True, or the adama_layerwise stream): "
                    "the full-pack schedule has a single monolithic "
                    "psum_scatter — there is no second bucket to double-"
                    "buffer; drop zero_bucketed=False or zero_async")

    def _check_wire_and_guard_fields(self):
        """The reference's checks of the wire, master-param, guard and
        scaler fields, in its order and with its messages."""
        if self.grad_dtype not in GRAD_DTYPES:
            raise ValueError(f"unknown grad_dtype {self.grad_dtype!r}; "
                             f"expected one of {GRAD_DTYPES}")
        if self.grad_dtype != "fp32" and not self.arena:
            raise ValueError(
                f"grad_dtype={self.grad_dtype!r} requires arena=True: the "
                f"gradient wire is the packed arena slab (core/arena.py); "
                f"pass arena=True use_pallas=True")
        if self.grad_dtype != "fp32" and self.accumulation == "ga":
            raise ValueError(
                f"grad_dtype={self.grad_dtype!r} with accumulation='ga' is "
                f"unsupported: the ga engine SUMS raw gradients across "
                f"micro-batches in the wire buffer, and bf16 accumulation "
                f"loses the fp32-accumulation guarantee the AdamA fold "
                f"kernels provide (they upcast in-kernel); use "
                f"accumulation='adama' or 'adama_layerwise'")
        if self.grad_dtype == "fp8_e4m3" and not self.finite_guard:
            raise ValueError(
                "grad_dtype='fp8_e4m3' requires finite_guard=True: e4m3 "
                "has no inf (overflow surfaces only as NaN codes, which "
                "the fused guards catch) and the error-feedback residual "
                "state['ef'] must be skip-predicated so a vetoed "
                "micro-batch does not corrupt it; pass finite_guard=True")
        if self.master_params and not self.arena:
            raise ValueError(
                "master_params=True requires arena=True: the fp32 master "
                "region is a packed arena alongside m/v "
                "(core/state_store.py); pass arena=True use_pallas=True")
        if self.work_param_cache and not self.master_params:
            raise ValueError(
                "work_param_cache=True requires master_params=True: the "
                "cache holds BF16 working params, so the fp32 truth must "
                "live in the master region 'p' — caching without a master "
                "would make the bf16 cast the stored truth and the "
                "precision loss would compound every step; pass "
                "master_params=True (or drop work_param_cache)")
        if self.finite_guard and not self.arena:
            raise ValueError(
                "finite_guard=True requires arena=True: the per-fold finite "
                "flag is a reduction over the packed gradient slab "
                "(kernels/fused_step.py); pass arena=True use_pallas=True")
        scale = parse_loss_scale(self.loss_scale)
        if scale != "off":
            if self.accumulation == "ga":
                raise ValueError(
                    f"loss_scale={self.loss_scale!r} with accumulation='ga' "
                    f"is unsupported: the ga engine folds the whole "
                    f"accumulated gradient once per step, so a skip loses "
                    f"the entire mini-batch — too coarse a signal to drive "
                    f"the dynamic backoff (and the ga wire is fp32-only "
                    f"anyway); use accumulation='adama' or "
                    f"'adama_layerwise'")
            if self.grad_dtype not in ("bf16", "fp8_e4m3"):
                raise ValueError(
                    f"loss_scale={self.loss_scale!r} requires a reduced-"
                    f"precision gradient wire (grad_dtype='bf16' or "
                    f"'fp8_e4m3' — loss scaling protects the wire), got "
                    f"grad_dtype={self.grad_dtype!r}; pass grad_dtype='bf16' "
                    f"or loss_scale='off'")
            if not self.finite_guard:
                raise ValueError(
                    f"loss_scale={self.loss_scale!r} requires "
                    f"finite_guard=True: skipped micro-batches drive the "
                    f"scale backoff, and an unguarded scaled run would fold "
                    f"scaled NaN/Inf into the arena; pass finite_guard=True")
        if self.scaler_growth_interval <= 0:
            raise ValueError(f"scaler_growth_interval must be > 0, got "
                             f"{self.scaler_growth_interval}")
        if self.scaler_abort_after < 0:
            raise ValueError(f"scaler_abort_after must be >= 0 (0 disables "
                             f"the abort), got {self.scaler_abort_after}")


def is_fp8_wire(opt: OptimizerConfig) -> bool:
    """The fp8_e4m3 gradient wire: slabs move as e4m3 codes with a per-row
    fp32 scale column, decoded inside the fold kernels (`grad_scale`)."""
    return opt.grad_dtype == "fp8_e4m3"


def use_error_feedback(opt: OptimizerConfig) -> bool:
    """Whether the state carries the fp8 wire's error-feedback residual
    "ef" (the reference's `use_error_feedback`): only the fp8 wire
    quantizes coarsely enough to need one, and error_feedback=False
    ablates it."""
    return is_fp8_wire(opt) and opt.error_feedback


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    optimizer: OptimizerConfig = OptimizerConfig()
    seq_len: int = 128
    global_batch: int = 16
    seed: int = 0
    steps: int = 100
    log_every: int = 10
    remat: bool = False          # activation checkpointing per layer
    checkpoint_dir: Optional[str] = None
    # checkpoint cadence in steps; 0 = max(log_every * 5, 50)
    checkpoint_every: int = 0
    # checkpoint retention (train/checkpoint.py _gc)
    keep_last_n: int = 3
    # fault-injection spec (train/faults.py parse_fault), test-only:
    # e.g. "nan@micro=1", "skip@micro=3,step=1", "crash@step=3"
    inject_fault: Optional[str] = None


ARCH_IDS = ["stablelm_1_6b", "bert_large", "rwkv6_7b", "mistral_nemo_12b",
            "minicpm3_4b", "deepseek_v2_lite_16b", "hymba_1_5b",
            "whisper_base", "internvl2_26b", "yi_9b", "deepseek_v2_236b"]

_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    arch = _ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}").CONFIG
