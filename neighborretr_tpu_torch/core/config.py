"""Typed configuration for the whole stack.

Replaces the reference's single mutable argparse namespace
(``NeighborRetr/config/args_parser.py:12-146``) with immutable dataclasses that
are threaded explicitly.  Dead reference flags (``--ot_temperature``,
``--memory_size`` — parsed but never read, see args_parser.py:32-33,105-106)
are intentionally dropped; memory-bank capacity is the honest quantity
``mb_batch * batch_size`` (utils/memory_bank.py:124-211 semantics).
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ClipConfig:
    """CLIP dual-encoder architecture (shape-compatible with OpenAI ViT-B/32|16).

    Defaults mirror the shape-sniffing result of the reference for ViT-B/32
    (modeling.py:88-101).
    """

    embed_dim: int = 512
    # vision tower
    image_resolution: int = 224
    vision_layers: int = 12
    vision_width: int = 768
    vision_patch_size: int = 32
    # text tower
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_layers: int = 12

    @property
    def transformer_heads(self) -> int:
        return self.transformer_width // 64

    @property
    def vision_heads(self) -> int:
        return self.vision_width // 64

    @property
    def grid_size(self) -> int:
        return self.image_resolution // self.vision_patch_size

    # CLI name → constructor attr (no annotation: not a dataclass field)
    _BACKBONES = {"ViT-B/32": "vit_b_32", "ViT-B/16": "vit_b_16",
                  "ViT-L/14": "vit_l_14",
                  "ViT-L/14@336px": "vit_l_14_336"}

    @staticmethod
    def vit_b_32() -> "ClipConfig":
        return ClipConfig()

    @classmethod
    def backbone_names(cls) -> Tuple[str, ...]:
        """CLI names accepted by `from_name` (the reference's --base_encoder
        menu, args_parser.py:134, plus ViT-L/14)."""
        return tuple(cls._BACKBONES)

    @classmethod
    def from_name(cls, name: str) -> "ClipConfig":
        """Resolve a --base_encoder CLI name; single source of truth for
        every CLI (train/eval/export)."""
        try:
            return getattr(cls, cls._BACKBONES[name])()
        except KeyError:
            raise ValueError(
                f"unknown base encoder {name!r}; "
                f"choose from {cls.backbone_names()}") from None

    @staticmethod
    def vit_b_16() -> "ClipConfig":
        return ClipConfig(vision_patch_size=16)

    @staticmethod
    def vit_l_14() -> "ClipConfig":
        """OpenAI ViT-L/14 shapes — beyond the reference's B/32|16 menu
        (README.md:68-74); the backbone the --tensor_parallel mesh is sized
        for.  weights_io's shape-sniffing loader handles its checkpoint
        unchanged."""
        return ClipConfig(
            embed_dim=768,
            vision_layers=24,
            vision_width=1024,
            vision_patch_size=14,
            transformer_width=768,
        )

    @staticmethod
    def vit_l_14_336() -> "ClipConfig":
        """OpenAI ViT-L/14@336px: the L/14 tower at 336² inputs (24×24
        patch grid → 577 vision tokens).  Same published-checkpoint zoo
        contract as the others (models/fetch.py); dataset resolution
        follows clip.image_resolution automatically."""
        return dataclasses.replace(ClipConfig.vit_l_14(),
                                   image_resolution=336)

    @staticmethod
    def tiny() -> "ClipConfig":
        """A tiny config for CPU tests."""
        return ClipConfig(
            embed_dim=64,
            image_resolution=32,
            vision_layers=2,
            vision_width=64,
            vision_patch_size=16,
            context_length=77,
            vocab_size=512,
            transformer_width=64,
            transformer_layers=2,
        )


@dataclass(frozen=True)
class ModelConfig:
    """Full NeighborRetr model architecture."""

    clip: ClipConfig = field(default_factory=ClipConfig)
    max_words: int = 24          # text tokens per caption (args_parser.py:112)
    max_frames: int = 12         # video frames per clip (args_parser.py:115)
    temporal_layers: int = 4     # --num_hidden_layers (args_parser.py:137)
    # CTM token-merging stacks (modeling.py:186-197): per-modality
    # (sample_ratio0, sample_ratio1) with k-NN density k=3, 8 heads.
    text_merge_ratios: Tuple[float, float] = (1.0 / 6.0, 1.0 / 4.0)
    video_merge_ratios: Tuple[float, float] = (1.0 / 4.0, 1.0 / 3.0)
    ctm_k: int = 3
    ctm_heads: int = 8
    # DPC-KNN density tie-break noise (cluster.py:483-484 adds U[0,1)·1e-6).
    # False → fully deterministic clustering (key=None) — used by golden
    # parity runs that compare whole training trajectories against the
    # reference with its torch.rand patched out.
    cluster_noise: bool = True
    # dtype policy: params fp32; matmul-heavy compute in bf16 with fp32
    # LayerNorm/softmax islands (module_clip.py LayerNorm fp32 behavior).
    compute_dtype: str = "bfloat16"
    # rematerialize encoder blocks in the backward pass (trade FLOPs for HBM)
    remat: bool = False
    # remat granularity: "full" (save carry only) or "dots" (save big matmul
    # outputs, recompute the rest) — see models/layers.py REMAT_POLICIES
    remat_policy: str = "full"
    # fused Pallas similarity kernel: "auto" (TPU only), "on", "off"
    use_pallas: str = "auto"
    # MXU operand dtype for the fused similarity kernel's dots on the
    # TRAINING path (fp32 accumulation either way; eval always fp32).
    # Measured on v5e: the compiled kernel produces BIT-IDENTICAL results
    # and timing for both settings — Mosaic lowers fp32 dot_general to
    # single-pass bf16 MXU multiplication by default — so this knob only
    # matters in interpret mode / future backends.
    sim_dtype: str = "float32"
    # unroll encoder layer stacks instead of lax.scan (bigger program,
    # cross-layer scheduling freedom for XLA)
    unroll_layers: bool = False
    # vision attention: "auto" (best kernel on TPU), "einsum" (XLA batched
    # matmuls), "fused" (Pallas frame-local attention kernel), or
    # "fused_block" (whole sublayer — qkv proj + attention + out proj — in
    # one Pallas kernel; the attention sublayer measures 40% of the train
    # step with the plain fused kernel on v5e)
    attention_impl: str = "auto"
    # with remat+unroll: save-all (skip remat) for the last N encoder layers —
    # each skipped layer trades ~2.6 GB HBM for ~4.5 ms/step on v5e
    remat_skip_last: int = 0
    # vision tower frame chunking: encode B·F frames in sequential chunks of
    # this many frames, each wrapped in jax.checkpoint.  Unlike per-layer
    # remat (whose lax.scan carry saves [layers, B·F, L, D] boundaries —
    # 7.9 GB at the 64-frame batch-128 recipe), only chunk inputs/outputs
    # persist; activations are bounded by ONE chunk.  0 = off.
    video_chunk_frames: int = 0

    def __post_init__(self):
        # The temporal transformer, weighting nets and CTM stacks all operate
        # on projected (embed_dim) features while being seeded from / shaped
        # like the text tower (transformer_width); the reference relies on
        # these being equal (512 for ViT-B/32|16, modeling.py:118-135).
        if self.clip.embed_dim != self.clip.transformer_width:
            raise ValueError(
                "embed_dim must equal transformer_width "
                f"(got {self.clip.embed_dim} vs {self.clip.transformer_width})")
        # Constructor-level so EVERY entry point (train/eval/index/search/
        # serve/export and API users) is covered: an oversized depth would
        # otherwise silently truncate in seed_temporal_from_clip's layer
        # slice — a different model than requested, with no error.
        if not 1 <= self.temporal_layers <= self.clip.transformer_layers:
            raise ValueError(
                f"temporal_layers {self.temporal_layers} must be in "
                f"[1, {self.clip.transformer_layers}]: the temporal tower "
                "is seeded from the first N CLIP text resblocks "
                "(modeling.py:199-220)")

    @property
    def width(self) -> int:
        return self.clip.embed_dim

    def merge_sizes(self, n_tokens: int, ratios: Tuple[float, float]) -> Tuple[int, int]:
        """Static cluster counts per CTM stage (cluster.py:707: ceil(N*ratio), min 1)."""
        n0 = max(math.ceil(n_tokens * ratios[0]), 1)
        n1 = max(math.ceil(n0 * ratios[1]), 1)
        return n0, n1

    @property
    def text_merge_sizes(self) -> Tuple[int, int]:
        return self.merge_sizes(self.max_words, self.text_merge_ratios)

    @property
    def video_merge_sizes(self) -> Tuple[int, int]:
        return self.merge_sizes(self.max_frames, self.video_merge_ratios)

    @staticmethod
    def tiny(max_words: int = 8, max_frames: int = 4,
             temporal_layers: int = 2) -> "ModelConfig":
        clip = ClipConfig.tiny()
        return ModelConfig(
            clip=clip,
            max_words=max_words,
            max_frames=max_frames,
            # tiny's 2-layer text tower can seed at most 2 temporal layers
            temporal_layers=min(temporal_layers, clip.transformer_layers),
            compute_dtype="float32",
        )


@dataclass(frozen=True)
class LossConfig:
    """Hubness-aware loss hyperparameters (args_parser.py:26-41 defaults)."""

    centrality_scale: float = 0.3
    kl_weight: float = 1.0
    uniform_weight: float = 1.0
    neighbor_weight: float = 1.0
    beta: float = 0.7            # Sinkhorn target interpolation
    num_neighbors: int = 20
    temperature: float = 3.0     # NOTE: the reference passes --temperature both as
    # the neighbor-loss softmax temperature AND as the uniform-loss logit scale
    # (modeling.py:440-441 argument aliasing). We replicate that behavior.
    sinkhorn_iterations: int = 50
    max_logit_scale: float = 100.0  # exp(logit_scale) clamp (trainer.py:112-119)


@dataclass(frozen=True)
class OptimizerConfig:
    """BertAdam-style optimizer (optimizer.py:64-75, optimization.py:76-210)."""

    lr: float = 1e-4
    coef_lr: float = 1e-3        # CLIP-branch lr multiplier → 1e-7
    weight_decay: float = 0.2
    warmup_proportion: float = 0.1
    schedule: str = "warmup_cosine"
    b1: float = 0.9
    b2: float = 0.98
    eps: float = 1e-6
    max_grad_norm: float = 1.0   # both the outer global clip and per-param clip
    # storage dtype for the Adam moments (m, v).  "bfloat16" halves optimizer
    # HBM (~3.4 GB → 1.7 GB for ViT-L/14) — the moment update itself always
    # runs in fp32 and only the carried state is rounded.
    moments_dtype: str = "float32"
    # where the carried moments LIVE between steps: "device" (HBM) or
    # "host" (pinned host memory; the step streams them in over PCIe, updates
    # in fp32 on device, streams back).  "host" frees moments-sized HBM
    # (~1.2 GB fp32 / 0.6 GB bf16 for ViT-B) for activation headroom — the
    # long-token recipe's chunk-512 lever — at the cost of a per-step
    # host↔device round trip that XLA's latency-hiding scheduler overlaps
    # with compute.  Incompatible with fsdp (moments are dp-sharded there).
    moments_placement: str = "device"


@dataclass(frozen=True)
class DataConfig:
    datatype: str = "msrvtt"
    data_path: str = ""
    video_path: str = ""
    max_words: int = 24
    max_frames: int = 12
    video_framerate: int = 1
    # (no separate image_resolution: frames decode at
    # model.clip.image_resolution — one source of truth)
    workers: int = 8
    # "thread" (cv2 releases the GIL) or "process" (forked workers; scales
    # Python-level augment cost across cores — reference DataLoader model)
    worker_mode: str = "thread"
    train_augment: bool = True
    # the train-time RandAugment policy string (timm grammar,
    # dataloader_retrieval.py:154-158); "" disables.  Lives in DataConfig so
    # the DEVICE backend (ops/device_augment.py, applied inside the train
    # step) can read it from the step's cfg.
    augment: str = "rand-m7-n4-mstd0.5-inc1"
    # "auto" | "native" | "pil" | "device" — native = the C++ clip kernels
    # in data/native (byte-exact vs PIL); device = torch ops on the batch's
    # device at the top of the train step, ahead of the frame normalisation
    # (ops/device_augment.py), freeing the host of the per-clip augment
    # cost; recorded here so the run's config dump captures which backend
    # produced the pixels
    augment_backend: str = "auto"
    # packed pre-decoded corpus directory (cli/pack_dataset.py /
    # data/packed.py); "" = decode from video files per epoch
    packed_dir: str = ""


@dataclass(frozen=True)
class TrainConfig:
    epochs: int = 5
    batch_size: int = 128        # global batch
    batch_size_val: int = 128
    mb_batch: int = 15           # memory-bank fill batches per epoch
    # storage dtype of the bank FEATURE tensors (train/memory_bank.py).
    # "bfloat16" halves the bank's HBM and its similarity streaming traffic
    # — the bank is no_grad state refreshed every step, so quantization
    # never accumulates; masks/ids stay exact.
    bank_dtype: str = "float32"
    # where the bank LIVES between steps: "device" (HBM) or "host"
    # (pinned host memory; the step streams it in and writes the FIFO
    # result back).  "host" frees bank-sized HBM (~252 MB bf16 at the
    # ActivityNet bank-1920/64f shape) for activation headroom at a
    # ~0.5 GB/step PCIe round trip.  TPU/GPU backends only (see
    # bertadam.host_offload_supported).
    bank_placement: str = "device"
    seed: int = 42
    n_display: int = 50
    output_dir: str = "outputs"
    init_checkpoint: Optional[str] = None
    clip_checkpoint: Optional[str] = None  # OpenAI .pt; None → random init
    # full-TrainState resume (params+opt+bank+step; see core/checkpoint.py)
    resume_checkpoint: Optional[str] = None
    save_checkpoints: bool = True
    # SIGTERM (TPU preemption / maintenance event) → save a resumable
    # state_preempt.npz at the next step boundary and exit cleanly
    save_on_preempt: bool = True
    mid_epoch_eval: bool = True  # eval every n_display*3 steps (trainer.py:169)
    # when set, capture a jax.profiler trace of a few early steps to this dir
    profile_dir: Optional[str] = None
    profile_steps: Tuple[int, int] = (10, 15)  # [start, end) global steps
    # parallelism
    data_axis: str = "data"
    num_devices: Optional[int] = None  # None → all
    # explicit shard_map losses (row-sharded similarity, Pallas kernels legal
    # per shard) instead of GSPMD auto-partitioning — see parallel/spmd.py
    explicit_spmd: bool = False
    # encode the batch in N sequential microbatches under jax.checkpoint while
    # the contrastive losses still see the FULL global batch — exact gradients
    # (GradCache semantics via lax.map + remat), peak activation memory ~N×
    # lower at the cost of a second encoder forward.  Lets global batches that
    # outgrow HBM (contrastive losses can't use naive grad accumulation)
    # train on one chip.  1 = off.
    micro_batches: int = 1
    # GPipe pipeline parallelism (parallel/pipeline.py): split transformer
    # towers depth-wise over a `stage` mesh axis of this size and stream
    # microbatches through the ring.  Requires a (data, stage) mesh
    # (pipeline.make_pp_mesh / cli --pipeline_parallel).  ≤1 = off.
    pipeline_parallel: int = 1
    # microbatches streamed through the pipeline per step; 0 → 4·stages
    # (bubble fraction (S−1)/(M+S−1))
    pipeline_microbatches: int = 0
    # FSDP / ZeRO-3: shard every parameter and its Adam moments over the
    # data axes (parallel/mesh.py::fsdp_param_shardings) — GSPMD gathers
    # weights just in time and reduce-scatters gradients.  ~dp× lower
    # param+moment memory for one extra weight all-gather per step.
    fsdp: bool = False

    @property
    def memory_bank_capacity(self) -> int:
        return self.mb_batch * self.batch_size


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optim: OptimizerConfig = field(default_factory=OptimizerConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "Config":
        raw = json.loads(text)
        clip = ClipConfig(**raw["model"].pop("clip"))
        model = ModelConfig(clip=clip, **{
            k: tuple(v) if isinstance(v, list) else v for k, v in raw["model"].items()
        })
        # JSON lists must come back as tuples everywhere: Config is a jit
        # static argument (train/step.py), so every field must be hashable,
        # and from_json(to_json(cfg)) must equal cfg
        train = TrainConfig(**{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in raw["train"].items()
        })
        return Config(
            model=model,
            loss=LossConfig(**raw["loss"]),
            optim=OptimizerConfig(**raw["optim"]),
            data=DataConfig(**raw["data"]),
            train=train,
        )


def validate(cfg: Config, num_devices: int) -> None:
    """Cross-field validation (mirrors args_parser.py:149-165 divisibility checks)."""
    if cfg.train.batch_size % num_devices != 0:
        raise ValueError(
            f"batch_size {cfg.train.batch_size} not divisible by device count {num_devices}"
        )
    if cfg.train.batch_size_val % num_devices != 0:
        raise ValueError(
            f"batch_size_val {cfg.train.batch_size_val} not divisible by device count {num_devices}"
        )
    if cfg.model.max_words != cfg.data.max_words or cfg.model.max_frames != cfg.data.max_frames:
        raise ValueError("model and data max_words/max_frames must agree")
    # temporal_layers bounds are enforced in ModelConfig.__post_init__ so
    # every entry point is covered at construction time
    mb = cfg.train.micro_batches
    if mb < 1 or cfg.train.batch_size % mb != 0:
        raise ValueError(
            f"micro_batches {mb} must divide batch_size {cfg.train.batch_size}")
    if mb > 1 and (cfg.train.batch_size // mb) % num_devices != 0:
        raise ValueError(
            f"microbatch size {cfg.train.batch_size // mb} not divisible by "
            f"device count {num_devices}")
    if cfg.train.n_display < 1:
        raise ValueError(f"n_display must be >= 1, got {cfg.train.n_display}")
    ps = cfg.train.profile_steps
    if cfg.train.profile_dir and not 0 <= ps[0] < ps[1]:
        raise ValueError(
            f"profile_steps must satisfy 0 <= start < stop, got {ps}")
    if mb > 1 and cfg.train.explicit_spmd:
        raise ValueError(
            "micro_batches applies to the GSPMD path; the explicit-SPMD path "
            "already encodes per shard (use model.video_chunk_frames to "
            "bound its memory)")
    if cfg.train.fsdp and cfg.train.explicit_spmd:
        raise ValueError(
            "fsdp shards params by GSPMD placement; the explicit-SPMD "
            "shard_map path would re-gather the full tree every step")
    if cfg.train.pipeline_microbatches < 0:
        raise ValueError(
            f"pipeline_microbatches must be >= 0 (0 → 4·stages), got "
            f"{cfg.train.pipeline_microbatches}")
    pp = cfg.train.pipeline_parallel
    if pp > 1:
        if cfg.train.fsdp:
            raise ValueError(
                "fsdp applies to pure data-parallel meshes; pipeline "
                "parallelism already shards params over `stage`")
        if cfg.train.explicit_spmd:
            raise ValueError(
                "pipeline_parallel nests shard_map and cannot combine with "
                "explicit_spmd's shard_map losses — use the GSPMD path")
        if mb > 1:
            raise ValueError(
                "pipeline_parallel already microbatches the towers; "
                "micro_batches > 1 is redundant (and lax.map around the "
                "pipeline's shard_map is unsupported)")
        if cfg.model.video_chunk_frames:
            raise ValueError(
                "video_chunk_frames wraps the vision tower in lax.map, "
                "which cannot nest around the pipeline's shard_map (and "
                "its chunk rarely divides into pipeline microbatches) — "
                "pipeline stages already bound per-chip memory; drop one")
        # num_devices is the DATA-parallel degree (callers pass the mesh's
        # `data` axis size, same convention as the batch checks above)
        m = cfg.train.pipeline_microbatches or 4 * pp
        if cfg.train.batch_size % (num_devices * m):
            raise ValueError(
                f"batch_size {cfg.train.batch_size} must divide by "
                f"data×pipeline_microbatches = {num_devices}×{m} so "
                "text/temporal rows split into whole microbatches per "
                "data shard")
    if cfg.optim.moments_placement not in ("device", "host"):
        raise ValueError(
            f"unknown moments_placement '{cfg.optim.moments_placement}' "
            "(device | host)")
    if cfg.train.bank_placement not in ("device", "host"):
        raise ValueError(
            f"unknown bank_placement '{cfg.train.bank_placement}' "
            "(device | host)")
    if cfg.optim.moments_placement == "host" and cfg.train.fsdp:
        raise ValueError(
            "moments_placement='host' assumes replicated moments; fsdp "
            "shards them over the data axis — the dp-sharded moments are "
            "already ~dp× smaller, drop one of the two")
    if cfg.data.augment_backend not in ("auto", "native", "pil", "device"):
        raise ValueError(
            f"unknown augment_backend '{cfg.data.augment_backend}' "
            "(auto | native | pil | device)")
    if cfg.data.augment_backend == "device" and cfg.data.augment:
        # fail at validate time, not at the first step
        from ..ops.device_augment import DeviceAugmentPolicy
        DeviceAugmentPolicy.parse(cfg.data.augment)
