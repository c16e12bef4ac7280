"""ds_config parsing for the training engine, PyTorch port.

A trimmed copy of ``deepspeed_tpu/runtime/config.py`` ``DeepSpeedConfig``
over the port's :mod:`.config_utils`.  It covers what the standard
training path reads: the batch triad and its checks, ``bf16`` (with
``master_weights: false``, master-free bf16 training), ``fp16`` (float16
compute over fp32 masters with a static or dynamic loss scale),
``optimizer``, ``scheduler``, ``gradient_clipping``,
``data_types.grad_accum_dtype``, ``activation_checkpointing``, ``seed``,
``steps_per_print``, ``checkpoint`` (verified loads, elastic resume,
retention; ``preemption_save`` is refused), ``zero_optimization.
offload_optimizer`` (ZeRO-Offload of the optimizer state to host memory or
NVMe, at every stage and across ranks; the deprecated ``cpu_offload: true``
spelling too) and ``aio`` (the NVMe swapper's I/O handle),
``zero_optimization.stage`` 0-3 with ``stage3_param_persistence_threshold``
(the bucket sizes and ``contiguous_gradients`` are accepted and recorded,
as hints, as in the JAX config), ``overlap_comm`` with
``overlap_bucket_layers``, the ZeRO++ knobs (:func:`zeropp_gate`: the JAX
engine's gate, which runs ZeRO++ at stage 3 over an fsdp axis > 1 and
leaves it inert elsewhere), ``comm_quantization``
(:class:`CommQuantizationConfig`, with the JAX config's checks) and the
``mesh`` section (or ``tpu.mesh``) with its data axes ``dp`` and ``fsdp``.
``world_size`` is the data-parallel world (dp × fsdp), which the batch
triad is resolved against.  The settings the port does not carry yet
raise ``NotImplementedError`` naming their ROADMAP.md line when they ask
for something: ``offload_param`` beyond stage 0 on one rank, the
whole-program ``offload_param`` path, pipeline, tensor, sequence and
expert parallelism (with the ``comm_quantization`` sites that need
them).  Observability sections (profilers, monitors, flight recorder,
goodput, watchdog, anomaly detection) are accepted only while disabled.
"""

from __future__ import annotations

import base64
import json
import os
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from pydantic import Field

from deepspeed_tpu_torch.runtime.config_utils import AUTO, DeepSpeedConfigModel


class FP16Config(DeepSpeedConfigModel):
    enabled: bool = False
    loss_scale: float = 0.0  # 0 => dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0
    auto_cast: bool = False

    @property
    def dynamic_loss_scale(self) -> bool:
        return self.loss_scale == 0.0


class BF16Config(DeepSpeedConfigModel):
    enabled: bool = False
    master_weights: bool = True


class OptimizerConfig(DeepSpeedConfigModel):
    type: str = "Adam"
    params: Dict[str, Any] = Field(default_factory=dict)


class SchedulerConfig(DeepSpeedConfigModel):
    type: Optional[str] = None
    params: Dict[str, Any] = Field(default_factory=dict)


class OffloadOptimizerConfig(DeepSpeedConfigModel):
    """``zero_optimization.offload_optimizer`` (the JAX package's
    ``DeepSpeedZeroOffloadOptimizerConfig``).  ``buffer_count``,
    ``pin_memory``, ``fast_init`` and ``ratio`` are accepted and without
    effect there as here."""

    device: str = "none"            # none | cpu | nvme
    nvme_path: Optional[str] = None
    buffer_count: int = 4
    pin_memory: bool = False
    # the NVMe swapper reads one leaf ahead and writes back asynchronously
    # unless these are turned off
    pipeline_read: bool = True
    pipeline_write: bool = True
    fast_init: bool = False
    ratio: float = 1.0
    # host masters and moments as blockwise int8 (cpu backend), shipped
    # H2D as codes and scales and dequantized on the card
    int8_masters: bool = False
    quant_block: int = 256


class OffloadParamConfig(DeepSpeedConfigModel):
    """``zero_optimization.offload_param`` (the JAX package's
    ``DeepSpeedZeroOffloadParamConfig``).  ``device`` ``cpu`` or ``nvme``
    (both keep the params in host memory, as the JAX engine does);
    ``nvme_path``, ``buffer_count``, ``buffer_size``, ``max_in_cpu`` and
    ``pin_memory`` are accepted and without effect there as here (the host
    copy is page-locked on the card whatever ``pin_memory`` says)."""

    device: str = "none"            # none | cpu | nvme
    nvme_path: Optional[str] = None
    buffer_count: int = 5
    buffer_size: int = 100_000_000
    max_in_cpu: int = 1_000_000_000
    pin_memory: bool = False
    # the backward streams a layer at a time, so no model-sized grad buffer
    # exists on the card; false asks for the whole-program path
    stream_grads: bool = True
    # layer i+1's H2D in flight while layer i computes (the same numbers
    # either way); int8_stream ships each layer as blockwise int8 codes and
    # scales dequantized on the card; staging_slots persistent layer-sized
    # device buffers take the copies
    prefetch: bool = True
    int8_stream: bool = False
    staging_slots: int = 2


class ZeroConfig(DeepSpeedConfigModel):
    """The ``zero_optimization`` keys the port reads: the stage, the
    stage-3 persistence threshold, the offload of the optimizer state and
    of the params, ``overlap_comm`` (the layer-bucketed schedule of
    ``runtime/zero/overlap.py``, ``overlap_bucket_layers`` layers a bucket)
    and the ZeRO++ switches (``runtime/zero/zeropp.py`` where the JAX engine
    runs ZeRO++, else inert with its reasons: :func:`zeropp_gate`).  The
    bucket sizes and ``contiguous_gradients`` are recorded (hints the JAX
    engine leaves to XLA); other keys are accepted."""

    stage: int = 0
    stage3_param_persistence_threshold: int = 100_000
    reduce_bucket_size: int = 500_000_000
    allgather_bucket_size: int = 500_000_000
    contiguous_gradients: bool = True
    overlap_comm: Optional[bool] = None
    overlap_bucket_layers: int = 1
    zero_quantized_weights: bool = False
    zero_quantized_gradients: bool = False
    zero_hpz_partition_size: int = 1
    offload_optimizer: Optional[OffloadOptimizerConfig] = None
    offload_param: Optional[OffloadParamConfig] = None
    cpu_offload: Optional[bool] = None  # deprecated spelling
    cpu_offload_params: Optional[bool] = None  # accepted, changes nothing

    def model_post_init(self, __context: Any) -> None:
        super().model_post_init(__context)
        if self.cpu_offload and self.offload_optimizer is None:
            object.__setattr__(self, "offload_optimizer",
                               OffloadOptimizerConfig(device="cpu"))


class CommQuantizationConfig(DeepSpeedConfigModel):
    """``comm_quantization``: blockwise int8 transport for the collectives
    (the JAX package's section; ``comm/collectives_q.py``).  The sites are
    tri-state: ``null`` follows ``enabled``, an explicit ``true`` or
    ``false`` wins.

    - ``grad_all_reduce``: the stage 0-2 boundary gradient sync, with an
      error-feedback residual (``error_feedback``);
    - ``all_gather`` / ``reduce_scatter``: the overlap schedule's bucket
      gathers and reduce-scatters, and at stage 3 without ``overlap_comm``
      the ZeRO++ path's qwZ / qgZ switches (either alone turns ZeRO++ on);
    - ``all_to_all``: MoE dispatch and ``comm.all_to_all_single(quantized=
      True)``;
    - ``sequence_ring`` / ``pipeline``: the sp ring and the pp boundary
      rings, which need the parallel meshes.

    A legacy ZeRO++ flag (``zero_quantized_weights`` /
    ``zero_quantized_gradients``) set true while its site is explicitly
    false raises, as ``block <= 0`` and ``pipeline`` under fp16 do
    (:meth:`DeepSpeedConfig._check_comm_quantization`)."""

    enabled: bool = False
    block: int = 256
    error_feedback: bool = True
    grad_all_reduce: Optional[bool] = None
    all_gather: Optional[bool] = None
    reduce_scatter: Optional[bool] = None
    all_to_all: Optional[bool] = None
    sequence_ring: Optional[bool] = None
    pipeline: Optional[bool] = None

    def _site(self, value: Optional[bool]) -> bool:
        return bool(self.enabled) if value is None else bool(value)

    @property
    def q_grad_all_reduce(self) -> bool:
        return self._site(self.grad_all_reduce)

    @property
    def q_all_gather(self) -> bool:
        return self._site(self.all_gather)

    @property
    def q_reduce_scatter(self) -> bool:
        return self._site(self.reduce_scatter)

    @property
    def q_all_to_all(self) -> bool:
        return self._site(self.all_to_all)

    @property
    def q_sequence_ring(self) -> bool:
        return self._site(self.sequence_ring)

    @property
    def q_pipeline(self) -> bool:
        return self._site(self.pipeline)


class MeshConfig(DeepSpeedConfigModel):
    """The ``mesh`` section (the JAX package's TPU extension, also read
    from ``tpu.mesh``): axis sizes, 0 inferred (``fsdp`` absorbs the rest
    of the world), and their order.  Only the data axes may exceed 1."""

    dp: int = 0
    fsdp: int = 0
    tp: int = 1
    pp: int = 1
    sp: int = 1
    ep: int = 1
    axis_order: List[str] = Field(default_factory=lambda: ["pp", "dp", "fsdp",
                                                           "ep", "sp", "tp"])


_ZERO_KEYS = ("stage", "offload_optimizer", "offload_param", "cpu_offload",
              "cpu_offload_params", "stage3_param_persistence_threshold",
              "reduce_bucket_size", "allgather_bucket_size",
              "contiguous_gradients", "overlap_comm", "overlap_bucket_layers",
              "zero_quantized_weights", "zero_quantized_gradients",
              "zero_hpz_partition_size")

_ONEBIT = ("onebitadam", "zerooneadam", "onebitlamb")


def _offloads(zero: Dict) -> bool:
    """Whether a ``zero_optimization`` dict offloads the optimizer state or
    the params."""
    off = zero.get("offload_optimizer") or {}
    p_off = zero.get("offload_param") or {}
    return (zero.get("cpu_offload") is True
            or off.get("device", "none") not in (None, "none")
            or p_off.get("device", "none") not in (None, "none"))


def zeropp_gate(d: Dict, world_size: int = 1) -> Tuple[bool, Optional[str]]:
    """The JAX engine's ZeRO++ gate (``runtime/engine.py`` ``__init__``):
    ``(wanted, reason)``, wanted when ``zero_quantized_weights``,
    ``zero_quantized_gradients`` or ``zero_hpz_partition_size > 1`` is set,
    or at stage 3 without ``overlap_comm`` when ``comm_quantization``'s
    ``all_gather`` or ``reduce_scatter`` site is on; the reason it would be
    inert, None where the JAX engine runs ZeRO++.  The fsdp size is the
    mesh section's over ``world_size`` ranks."""
    zero = d.get("zero_optimization") or {}
    hpz = int(zero.get("zero_hpz_partition_size", 1) or 1)
    cq = CommQuantizationConfig(**(d.get("comm_quantization") or {}))
    stage = int(zero.get("stage", 0) or 0)
    if not (zero.get("zero_quantized_weights") is True
            or zero.get("zero_quantized_gradients") is True or hpz > 1
            or (stage == 3 and not zero.get("overlap_comm")
                and (cq.q_all_gather or cq.q_reduce_scatter))):
        return False, None
    from deepspeed_tpu_torch.comm.mesh import build_mesh

    mesh_cfg = MeshConfig(**mesh_section(d))
    mesh = build_mesh(dp=mesh_cfg.dp, fsdp=mesh_cfg.fsdp, tp=mesh_cfg.tp,
                      pp=mesh_cfg.pp, sp=mesh_cfg.sp, ep=mesh_cfg.ep,
                      world_size=world_size, rank=0, make_groups=False)
    bad = [a for a in ("tp", "sp", "pp", "ep") if mesh.shape.get(a, 1) > 1]
    fsdp = mesh.shape.get("fsdp", 1)
    opt = ((d.get("optimizer") or {}).get("type") or "").lower()
    onebit = opt.replace("_", "").replace("-", "") in _ONEBIT
    if stage != 3:
        return True, "requires ZeRO stage 3 (sharded params)"
    if _offloads(zero) or onebit:
        return True, "not combinable with offload or 1-bit optimizers"
    if (d.get("fp16") or {}).get("enabled"):
        return True, "requires bf16/fp32 (no fp16 loss scaling)"
    if bad:
        return True, (f"model/expert-parallel axes {bad} are not supported "
                      "on the ZeRO++ path")
    if fsdp <= 1:
        return True, "needs an fsdp mesh axis > 1"
    if hpz > 1 and fsdp % hpz:
        return True, f"hpz size {hpz} must divide fsdp={fsdp}"
    return True, None


def mesh_section(d: Dict) -> Dict:
    """The ``mesh`` section, or ``tpu.mesh``, of a config dict."""
    tpu = d.get("tpu")
    return d.get("mesh") or ((tpu.get("mesh") if isinstance(tpu, dict) else None)
                             or {})


class AIOConfig(DeepSpeedConfigModel):
    """``aio``: the NVMe swapper's I/O handle."""

    block_size: int = 1_048_576
    queue_depth: int = 8
    thread_count: int = 1
    single_submit: bool = False
    overlap_events: bool = True


class DataTypesConfig(DeepSpeedConfigModel):
    grad_accum_dtype: Optional[str] = None  # None -> fp32


class ActivationCheckpointingConfig(DeepSpeedConfigModel):
    # enabled=None leaves the model's own remat default; True/False forces
    # per-layer checkpointing on or off (the JAX package's extension)
    enabled: Optional[bool] = None
    policy: str = "full"
    partition_activations: bool = False
    cpu_checkpointing: bool = False
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False


class CheckpointConfig(DeepSpeedConfigModel):
    # accepted and without effect, as in the JAX engine (it never reads
    # them): tag_validation, load_universal, use_node_local_storage,
    # parallel_write, async_save
    tag_validation: str = "Warn"
    load_universal: bool = False
    use_node_local_storage: bool = False
    parallel_write: Dict[str, Any] = Field(default_factory=dict)
    async_save: bool = False
    # verify MANIFEST.json (existence + size + sha256) before a load trusts
    # a tag's bytes; on failure the loader walks back to the newest valid tag
    verify_on_load: bool = True
    # also verify each chunk's sha256 in the shard indexes (names the leaf)
    deep_verify_on_load: bool = False
    # on a resume at another data-parallel size, rescale
    # gradient_accumulation_steps so the recorded global batch is kept
    elastic_resume: bool = True
    # after a committed save, delete the oldest valid tags beyond this
    # count (never the one `latest` names); 0 keeps everything
    keep_last_n: int = 0
    # SIGTERM -> emergency save (runtime/preemption.py): refused
    preemption_save: bool = False
    save_dir: Optional[str] = None


_DTYPES = {"fp32": torch.float32, "float32": torch.float32, "float": torch.float32,
           "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
           "fp16": torch.float16, "float16": torch.float16}

# sections that observe or steer a run: accepted only while disabled
_OBSERVABILITY = ("flops_profiler", "profile_trace", "tensorboard", "wandb",
                  "csv_monitor", "comms_logger", "flight_recorder", "goodput",
                  "watchdog", "continuous_profiler", "anomaly_detection",
                  "elasticity", "data_efficiency", "compression_training",
                  "autotuning", "amp")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md queue 1: "
                               f"{item})")


def _load_config_dict(config: Union[str, Dict, None]) -> Dict:
    if config is None:
        return {}
    if isinstance(config, dict):
        return dict(config)
    if isinstance(config, (str, os.PathLike)):
        path = str(config)
        if os.path.exists(path):
            with open(path, "r") as fh:
                return json.load(fh)
        try:
            return json.loads(base64.urlsafe_b64decode(path).decode("utf-8"))
        except Exception:
            pass
        try:
            return json.loads(path)
        except Exception as exc:
            raise ValueError(f"Expected a path to a ds_config JSON file, a JSON "
                             f"string, or a dict; got {path!r}") from exc
    raise TypeError(f"Unsupported config type: {type(config)}")


def _scalar(d: Dict, key: str, default: Any) -> Any:
    v = d.get(key, default)
    return default if v == AUTO else v


def resolve_batch_triad(train_batch_size: Optional[int],
                        micro_batch_per_gpu: Optional[int],
                        grad_accum_steps: Optional[int], world_size: int):
    """Fill in any missing member of ``train_batch_size =
    train_micro_batch_size_per_gpu * gradient_accumulation_steps *
    world_size`` (the JAX package's rules, check for check)."""
    tbs, mbs, gas = train_batch_size, micro_batch_per_gpu, grad_accum_steps
    if tbs is not None and mbs is not None and gas is not None:
        if tbs != mbs * gas * world_size:
            raise ValueError(
                f"Inconsistent batch config: train_batch_size={tbs} != "
                f"micro_batch({mbs}) * grad_accum({gas}) * world_size({world_size})")
        return tbs, mbs, gas
    if tbs is None and mbs is not None and gas is not None:
        return mbs * gas * world_size, mbs, gas
    if mbs is None and tbs is not None and gas is not None:
        if tbs % (gas * world_size) != 0:
            raise ValueError(f"train_batch_size {tbs} not divisible by "
                             f"grad_accum*world {gas * world_size}")
        return tbs, tbs // (gas * world_size), gas
    if gas is None and tbs is not None and mbs is not None:
        if tbs % (mbs * world_size) != 0:
            raise ValueError(f"train_batch_size {tbs} not divisible by "
                             f"micro_batch*world {mbs * world_size}")
        return tbs, mbs, tbs // (mbs * world_size)
    if tbs is not None:
        if tbs % world_size != 0:
            raise ValueError(f"train_batch_size {tbs} not divisible by "
                             f"world_size {world_size}")
        return tbs, tbs // world_size, 1
    if mbs is not None:
        return mbs * world_size, mbs, 1
    if gas is not None:
        return gas * world_size, 1, gas
    return world_size, 1, 1


class DeepSpeedConfig:
    """Parsed, validated view of a ds_config (the training path's sections).
    ``world_size`` is the data-parallel world the batch triad divides by
    (dp × fsdp of the mesh; 1 on one card)."""

    def __init__(self, config: Union[str, Dict, None], world_size: int = 1):
        self._param_dict = d = _load_config_dict(config)
        self.comm_quantization = self._check_comm_quantization(d)
        self._refuse_unported(d, int(world_size))
        self.world_size = int(world_size)
        self.mesh = MeshConfig(**mesh_section(d))

        tbs, mbs, gas = (None if d.get(k) == AUTO else d.get(k)
                         for k in ("train_batch_size",
                                   "train_micro_batch_size_per_gpu",
                                   "gradient_accumulation_steps"))
        (self.train_batch_size, self.train_micro_batch_size_per_gpu,
         self.gradient_accumulation_steps) = resolve_batch_triad(tbs, mbs, gas,
                                                                 self.world_size)

        self.steps_per_print = _scalar(d, "steps_per_print", 10)
        self.gradient_clipping = _scalar(d, "gradient_clipping", 0.0)
        self.seed = _scalar(d, "seed", 42)

        self.fp16 = FP16Config(**d.get("fp16", {}))
        self.bf16 = BF16Config(**d.get("bf16", d.get("bfloat16", {})))
        self.data_types = DataTypesConfig(**d.get("data_types", {}))
        self.optimizer = OptimizerConfig(**d["optimizer"]) if "optimizer" in d else None
        self.scheduler = SchedulerConfig(**d["scheduler"]) if "scheduler" in d else None
        self.activation_checkpointing = ActivationCheckpointingConfig(
            **d.get("activation_checkpointing", {}))
        self.checkpoint_config = CheckpointConfig(**d.get("checkpoint", {}))
        self.zero_config = ZeroConfig(**{k: v for k, v in
                                         (d.get("zero_optimization") or {}).items()
                                         if k in _ZERO_KEYS})
        self.aio = AIOConfig(**d.get("aio", {}))
        self._validate()

    @staticmethod
    def _check_comm_quantization(d: Dict) -> CommQuantizationConfig:
        """The ``comm_quantization`` section and the JAX config's checks of
        it: a legacy ZeRO++ flag set true while its site is explicitly false
        (the one contradiction a config can show: a legacy flag left at its
        default false is silence, not an "off"), ``block <= 0``, and the
        ``pipeline`` site under fp16 raise ``ValueError``."""
        cq = CommQuantizationConfig(**(d.get("comm_quantization") or {}))
        zero = d.get("zero_optimization") or {}
        for legacy_key, site_key, site_val in (
                ("zero_quantized_weights", "all_gather", cq.all_gather),
                ("zero_quantized_gradients", "reduce_scatter", cq.reduce_scatter)):
            legacy_val = bool(zero.get(legacy_key, False))
            if legacy_val and site_val is False:
                raise ValueError(
                    f"conflicting quantized-comm config: zero_optimization."
                    f"{legacy_key}={legacy_val} but comm_quantization."
                    f"{site_key}={site_val}.  The legacy flag is the ZeRO++ "
                    f"spelling of the comm_quantization site — set them to "
                    f"agree or drop one (precedence rule: contradictions "
                    f"raise, they are never silently resolved)")
        if cq.block <= 0:
            raise ValueError("comm_quantization.block must be positive")
        if (d.get("fp16") or {}).get("enabled") and cq.q_pipeline:
            raise ValueError(
                "comm_quantization.pipeline cannot arm under fp16: the "
                "backward boundary ring carries loss-SCALED cotangents, and "
                "int8 saturation maps inf/nan onto finite codes — the fp16 "
                "overflow detector (skip-vs-apply) would read clean "
                "gradients through an overflowed boundary.  Use bf16 (no "
                "loss scaling, overflow-free boundary codes), or keep the "
                "pipeline boundary dense (comm_quantization.pipeline: "
                "false) under fp16")
        return cq

    @staticmethod
    def _refuse_unported(d: Dict, world_size: int = 1) -> None:
        zero = d.get("zero_optimization") or {}
        stage = int(zero.get("stage", 0) or 0)
        p_off = zero.get("offload_param") or {}
        if (p_off.get("device", "none") not in (None, "none")
                and (stage >= 1 or world_size > 1)):
            raise _not_ported(f"offload_param at zero_optimization.stage "
                              f"{stage}, data-parallel world {world_size}",
                              "item 2e, offload_param across ranks")
        if (p_off.get("device", "none") not in (None, "none")
                and p_off.get("stream_grads", True) is False):
            raise _not_ported("zero_optimization.offload_param.stream_grads: "
                              "false", "item 2e, the whole-program offload_param "
                              "path")
        cq = CommQuantizationConfig(**(d.get("comm_quantization") or {}))
        mesh = mesh_section(d)
        for site, on, axis in (("all_to_all", cq.q_all_to_all, "ep"),
                               ("sequence_ring", cq.q_sequence_ring, "sp"),
                               ("pipeline", cq.q_pipeline, "pp")):
            size = mesh.get(axis, 1)
            if on and isinstance(size, int) and size > 1:
                raise _not_ported(f"comm_quantization.{site} over the {axis} "
                                  f"axis ({axis}={size})",
                                  "item 2e, the parallel meshes")
        if d.get("pipeline"):
            raise _not_ported("pipeline parallelism", "item 2e, the parallel "
                              "meshes")
        big = {k: v for k, v in mesh.items()
               if k not in ("dp", "fsdp") and isinstance(v, int) and v > 1}
        if big:
            raise _not_ported(f"mesh axes {big}", "item 2e, the parallel meshes")
        tp = d.get("tensor_parallel") or {}
        if int(tp.get("tp_size", tp.get("autotp_size", 1)) or 1) > 1:
            raise _not_ported("tensor_parallel", "item 2e, the parallel meshes")
        for key in _OBSERVABILITY:
            sec = d.get(key)
            if isinstance(sec, dict) and sec.get("enabled"):
                raise _not_ported(f"{key}.enabled", "the observability hooks")
        if (d.get("checkpoint") or {}).get("preemption_save"):
            raise _not_ported("checkpoint.preemption_save", "the rest of the "
                              "package (runtime/preemption.py)")

    @property
    def fp16_enabled(self) -> bool:
        return bool(self.fp16.enabled)

    @property
    def loss_scale(self) -> float:
        return self.fp16.loss_scale

    @property
    def dynamic_loss_scale(self) -> bool:
        return self.fp16.dynamic_loss_scale

    def dtype(self) -> torch.dtype:
        """The compute dtype: bf16, fp16 (over fp32 masters) or fp32."""
        if self.bf16.enabled:
            return torch.bfloat16
        if self.fp16.enabled:
            return torch.float16
        return torch.float32

    def master_dtype(self) -> torch.dtype:
        """fp32 masters, or bf16 ones under ``bf16.master_weights: false``."""
        master_free = self.bf16.enabled and not self.bf16.master_weights
        return torch.bfloat16 if master_free else torch.float32

    def grad_accum_dtype(self) -> torch.dtype:
        name = self.data_types.grad_accum_dtype
        return torch.float32 if name is None else _DTYPES[name.lower()]

    @property
    def param_offload(self) -> bool:
        """``offload_param`` on ``cpu`` or ``nvme``: the params live in host
        memory and stream to the card a layer at a time."""
        p_off = self.zero_config.offload_param
        return p_off is not None and p_off.device in ("cpu", "nvme")

    @property
    def offload_device(self) -> str:
        """Where the optimizer state lives: "none", "cpu" or "nvme".
        ``offload_param`` without ``offload_optimizer`` puts it on
        ``offload_param.device``, as the JAX engine does."""
        off = self.zero_config.offload_optimizer
        dev = off.device if off is not None else "none"
        if dev == "none" and self.param_offload:
            return self.zero_config.offload_param.device
        return dev

    def offload_optimizer_config(self) -> OffloadOptimizerConfig:
        """The host optimizer's settings: the ``offload_optimizer`` section,
        or under ``offload_param`` alone its defaults on the params' device
        (with ``offload_param.nvme_path``)."""
        off = self.zero_config.offload_optimizer
        if off is not None and off.device != "none":
            return off
        p_off = self.zero_config.offload_param
        return OffloadOptimizerConfig(device=p_off.device, nvme_path=p_off.nvme_path)

    def _validate(self) -> None:
        p_off = self.zero_config.offload_param
        if p_off is not None and p_off.device not in ("none", "cpu", "nvme"):
            raise ValueError(f"zero_optimization.offload_param.device "
                             f"{p_off.device!r}: none, cpu or nvme")
        if self.param_offload and self.fp16.enabled:
            raise ValueError("offload_param does not support fp16 loss "
                             "scaling; use bf16 (TPU-native) instead")
        if self.offload_device not in ("none", "cpu", "nvme"):
            raise ValueError(f"zero_optimization.offload_optimizer.device "
                             f"{self.offload_device!r}: none, cpu or nvme")
        if self.offload_device == "nvme" and not self.offload_optimizer_config().nvme_path:
            raise ValueError("zero_optimization.offload_optimizer.device nvme "
                             "needs nvme_path")
        if self.fp16.enabled and self.bf16.enabled:
            raise ValueError("fp16 and bf16 cannot both be enabled")
        ga = self.data_types.grad_accum_dtype
        if ga is not None and ga.lower() not in _DTYPES:
            raise ValueError(f"data_types.grad_accum_dtype: unknown dtype {ga!r}")
        if self.fp16.enabled and ga is not None and _DTYPES[ga.lower()] != torch.float32:
            raise ValueError("fp16 loss scaling requires fp32 gradient "
                             "accumulation (data_types.grad_accum_dtype)")
