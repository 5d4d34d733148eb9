"""Typed configuration for devt_tpu_torch.

Own copy of ``devt_tpu/config.py``: the same flat keys (the reference's
``config.yaml`` surface plus the execution knobs), the same defaults and
the same validation, so one YAML file configures either package.

``attention_impl`` in this package:
  * ``"auto"``, ``"pallas"``, ``"fused_interpret"`` — eligible ViT blocks
    run the fused block math (the CUDA kernel on the card, its plain
    PyTorch version on the CPU): what the JAX package runs on the TPU.
  * ``"xla"`` — the unfused path (LayerNorm, Linear, materialised softmax
    attention, exact-erf GELU).
  * in PTN's torch-semantics encoder: ``"auto"`` and ``"pallas"`` run the
    packed-qkv attention kernels on the card, forward and backward; on the
    CPU ``"pallas"`` runs their plain versions and ``"auto"``, like
    ``"xla"``, the materialised softmax attention.

``dp``, ``mp``, ``pp`` and ``sp`` lay out the mesh (``parallel/mesh.py``):
(data, model), (data, pipe), the 3-D (data, pipe, model) or (data, seq).
``dp_mode`` picks data parallelism, FSDP (``"fsdp"``) or the GSPMD
formulations (``"gspmd"``, ``"fsdp_gspmd"``); ``mp`` > 1 is tensor
parallelism, ``pp`` > 1 the GPipe pipeline over ``pp_microbatches``
microbatches (default one a stage) and ``sp`` > 1 sequence parallelism
over the kv ring, both on ViViT's stacked space transformer
(``parallel/train_step.py``).  ``moe_ep`` runs the switch-MoE blocks
expert-parallel over a data axis of more than one rank, and changes
nothing on one device, as in the JAX package.  ``remat``
rematerialises each transformer block or encoder layer of a training
step (``models.layers.remat``).  ``moe_experts`` gives the ViViT space
transformer its switch-MoE blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Mapping, Sequence

# 15-genre MMX temporal labels
# (src/dataloaders/mmx/MMX_Temporal_dl.py:118-132).
MMX_GENRES_15 = (
    "Action", "Adventure", "Comedy", "Crime", "Documentary", "Drama",
    "Family", "Fantasy", "History", "Horror", "Music", "Mystery",
    "Science Fiction", "Thriller", "War",
)
# 19-genre MMX frame/light labels (src/callbacks/callbacks.py:31-32).
MMX_GENRES_19 = (
    "Action", "Animation", "Adventure", "Comedy", "Crime", "Documentary",
    "Drama", "Family", "Fantasy", "History", "Horror", "Music", "Romance",
    "Mystery", "TVMovie", "ScienceFiction", "Thriller", "War", "Western",
)


@dataclasses.dataclass
class Config(Mapping[str, Any]):
    """Flat config: the reference's key surface plus execution knobs."""

    # --- General params (src/config.yaml:1-7) ---
    batch_size: int = 2
    learning_rate: float = 0.000005
    epochs: int = 500
    seq_len: int = 13
    frame_len: int = 12
    test: bool = False

    # --- Optimisation (src/config.yaml:9-16) ---
    dropout: float = 0.5
    momentum: float = 0.005
    weight_decay: float = 0.09
    scheduling: bool = True
    warm_up: int = 2
    n_classes: int = 15
    opt: str = "adamW"

    # --- Architecture (src/config.yaml:21-26) ---
    input_dimension: int = 2048
    nhead: int = 8
    token_embedding: int = 305
    nlayers: int = 8
    nhid: int = 2048
    projection_size: int = 305

    # --- Selectors (src/config.yaml:27-33) ---
    data_set: str = "mmx-frame"
    model: str = "vid"
    logger: str = "double_transformer"
    name: str = "devt-tpu-run"

    # --- Experts / tokens / mixing (src/config.yaml:36-42) ---
    experts: Sequence[str] = (
        "img-embeddings", "location-embeddings", "video-embeddings",
    )
    cls: int = 1
    mixing_method: str = "double_trans"

    # --- Paths / device (src/config.yaml:44-45) ---
    device: int = 1
    save_path: str = "trained_models/"

    # --- Contrastive-model key set (src/models/contrastivemodel.py:15-20) ---
    input_shape: int = 2048
    hidden_layer: int = 2048
    output_shape: int = 128
    num_samples: int = 50000
    aggregation: str = "none"
    temperature: float = 0.5

    # --- Data locations ---
    train_manifest: str = "data/mmx/mmx_train_temporal.pkl"
    val_manifest: str = "data/mmx/mmx_val_temporal.pkl"
    csv_manifest: str = "data/mmx/light/out.csv"

    # --- Execution knobs (no reference equivalent) ---
    seed: int = 1130                   # the reference seeds torch with 1130
    precision: str = "bf16"            # "bf16" | "f32"
    accum_steps: int = 1
    data_axis: str = "data"
    model_axis: str = "model"
    dp: int = -1
    mp: int = 1
    pp: int = 1                        # pipeline stages
    pp_microbatches: int = 0
    sp: int = 1                        # sequence parallel width
    attention_impl: str = "auto"       # see the module docstring
    dp_mode: str = "auto"
    remat: bool = False
    grad_clip_norm: float = 0.0
    moe_experts: int = 0               # switch-MoE FFNs in the vivit
    moe_every: int = 2
    moe_aux_weight: float = 0.01
    moe_capacity_factor: float = 1.25
    moe_ep: bool = False
    moment_dtype: str = "f32"
    log_every: int = 50
    eval_every_epochs: int = 1
    checkpoint_dir: str = "checkpoints"
    resume: str = ""
    best_metric: str = ""
    best_mode: str = "max"
    keep_best_k: int = 1
    max_steps: int = -1
    profile_dir: str = ""
    host_batch_prefetch: int = 2
    unroll_steps: int = 1
    wire_format: str = "f32"           # "f32" | "u8" | "u8_tokens"

    # ------------------------------------------------------------------
    def __post_init__(self) -> None:
        if self.opt not in ("sgd", "adamW", "adagrad", "adam", "adafactor"):
            raise ValueError(f"unknown optimiser {self.opt!r}")
        if self.moment_dtype not in ("f32", "bf16"):
            raise ValueError(f"unknown moment_dtype {self.moment_dtype!r}")
        if self.precision not in ("bf16", "f32"):
            raise ValueError(f"unknown precision {self.precision!r}")
        if self.attention_impl not in ("auto", "pallas", "xla",
                                       "fused_interpret"):
            raise ValueError(f"unknown attention impl {self.attention_impl!r}")
        if self.wire_format not in ("f32", "u8", "u8_tokens"):
            raise ValueError(f"unknown wire format {self.wire_format!r}")
        if self.wire_format == "u8_tokens" and self.model != "vivit":
            raise ValueError(
                "wire_format 'u8_tokens' is the pre-patchified ViT token "
                "wire — only the vivit model consumes it")
        if self.dp_mode not in ("auto", "gspmd", "fsdp", "fsdp_gspmd"):
            raise ValueError(f"unknown dp_mode {self.dp_mode!r}")
        if self.pp > 1:
            if self.mp > 1 and self.attention_impl == "xla":
                raise ValueError("pp x mp runs each stage on the fused "
                                 "kernels; attention_impl='xla' cannot")
            if self.model != "vivit":
                raise ValueError("pipeline parallelism is implemented for "
                                 "the vivit depth stack (config.pp)")
            if self.dropout > 0.0:
                raise ValueError("pp > 1 requires dropout == 0.0")
            if self.moe_experts > 0:
                raise ValueError("pp > 1 does not compose with MoE blocks")
        if self.sp > 1:
            if self.mp > 1 or self.pp > 1:
                raise ValueError("sp composes with dp only (mp=pp=1)")
            if self.model != "vivit":
                raise ValueError("sequence parallelism is implemented "
                                 "for the vivit space transformer")
            if self.dropout > 0.0:
                raise ValueError("sp > 1 requires dropout == 0.0")
            if self.moe_experts > 0:
                raise ValueError("sp > 1 does not compose with MoE blocks")
        if self.moe_ep:
            if self.moe_experts <= 0:
                raise ValueError("moe_ep requires moe_experts > 0")
            if self.mp > 1 or self.pp > 1:
                raise ValueError("moe_ep does not compose with mp/pp")
            if self.dp_mode not in ("auto",):
                raise ValueError("moe_ep requires dp_mode='auto'")
        if self.best_mode not in ("max", "min"):
            raise ValueError(f"unknown best_mode {self.best_mode!r}")

    # Mapping protocol: ``cfg["batch_size"]`` reads work like the
    # reference's ``wandb.config`` dict access.
    def __getitem__(self, key: str) -> Any:
        try:
            return getattr(self, key)
        except AttributeError:
            raise KeyError(key) from None

    def __iter__(self) -> Iterator[str]:
        return iter(f.name for f in dataclasses.fields(self))

    def __len__(self) -> int:
        return len(dataclasses.fields(self))

    def replace(self, **updates: Any) -> "Config":
        return dataclasses.replace(self, **updates)

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["experts"] = list(d["experts"])
        return d

    # ------------------------------------------------------------------
    @classmethod
    def from_dict(cls, raw: Mapping[str, Any],
                  strict: bool = False) -> "Config":
        """Build from a flat dict, ignoring unknown keys unless ``strict``."""
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - known
        if unknown and strict:
            raise KeyError(f"unknown config keys: {sorted(unknown)}")
        kwargs = {k: v for k, v in raw.items() if k in known}
        if "experts" in kwargs and kwargs["experts"] is not None:
            kwargs["experts"] = tuple(kwargs["experts"])
        return cls(**kwargs)

    @classmethod
    def from_yaml(cls, path: str, strict: bool = False) -> "Config":
        """Load the reference's flat ``config.yaml`` format."""
        import yaml  # only YAML users need PyYAML

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        return cls.from_dict(raw, strict=strict)
