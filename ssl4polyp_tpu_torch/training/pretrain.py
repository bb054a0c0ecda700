"""MAE pretraining engine: the train step and a resumable epoch loop.

Counterpart of ``ssl4polyp_tpu/training/pretrain.py`` (reference
``mae/main_pretrain.py`` and ``engine_pretrain.py``):

* bf16 compute with fp32 master parameters and fp32 AdamW (0.9, 0.95): the
  forward reads a compute copy (matrices in bf16, vectors the fp32 masters,
  cast at use), gradients are taken with respect to that copy and reach
  AdamW in fp32, and the copy is refreshed after the update; under
  ``precision="fp32"`` the compute copy is the masters themselves and the
  card runs the fp32 kernels;
* gradient accumulation over ``accum_iter`` microbatches inside one step;
* per-iteration warmup and half-cycle cosine learning rate, scaled by the
  effective batch / 256; no weight decay on biases, norms, tokens and
  position tables; learning rate 0 on the frozen sin-cos tables;
* epoch checkpoints in the JAX package's layout, so that either package
  resumes the other's files, with retention (keep-last-K + every-N
  milestones), a ``last`` pointer, asynchronous writes, SIGTERM/SIGINT
  save-and-exit and auto-resume;
* a non-finite-loss abort and JSON epoch log lines (``RunLogger``).

The masking noise of each step comes from an explicit generator seeded from
(seed, epoch, step), so a run is a function of its settings, and a resumed
run equals the uninterrupted one bit for bit when it resumes where an epoch
ended.  ``steps_per_call`` = K runs K calls of the step per round of the
loop, each at its own schedule value and noise: the same calls as K = 1.

Data parallelism (``..parallel``): launched as N ranks (``torchrun``), every
rank loads ``effective_batch / N`` rows a step from its stripe of the epoch's
order (``accum_iter`` microbatches of ``batch_size / N``), takes its slice of
the step's global noise, and all-reduces the mean gradient once, after its
microbatches, so every rank takes the same update.  Only rank 0 writes
(logs and checkpoints: the others skip the host snapshot too), and a signal
on any rank stops every rank after the same step.
"""

from __future__ import annotations

import dataclasses
import math
import signal
import time
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch
from torch.func import functional_call

from ..data.augment import normalize_batch
from ..data.folder import ImageFolderIndex, PretrainLoader
from ..models.layers import compute_copy
from ..models.mae import MAE, MAE_VIT_B16, MAEConfig
from ..models.weights import jax_from_mae_state_dict, mae_state_dict_from_jax
from ..parallel import (any_rank, barrier, build_mesh, cross_replica_mean, initialize_multihost,
                        is_distributed, is_primary, local_device, process_index, replicate)
from ..utils.checkpoint import (
    AsyncCheckpointer,
    cleanup_checkpoints,
    load_checkpoint,
    save_checkpoint,
    update_pointer,
)
from ..utils.determinism import set_determinism, step_seed
from ..utils.logging import RunLogger, Throughput
from . import optim
from .schedules import warmup_cosine

__all__ = [
    "PretrainSettings",
    "PretrainState",
    "checkpoint_payload",
    "cli_main",
    "find_resume_path",
    "init_pretrain_state",
    "loss_and_grads",
    "make_pretrain_step",
    "model_config",
    "restore_state",
    "run_pretraining",
]


@dataclass
class PretrainSettings:
    data_root: str = ""
    output_dir: str = "outputs/mae_pretrain"
    model: str = "mae_vit_base_patch16"
    epochs: int = 400
    warmup_epochs: int = 40
    batch_size: int = 64  # per accumulation microbatch, over all ranks
    accum_iter: int = 1
    blr: float = 1e-3
    min_lr: float = 0.0
    weight_decay: float = 0.05
    mask_ratio: float = 0.75
    norm_pix_loss: bool = False
    seed: int = 0
    image_size: int = 224
    num_workers: int = 16
    log_interval: int = 20
    save_freq_epochs: int = 20
    save_freq_mins: Optional[float] = None  # time-based mid-epoch saves
    keep_last: int = 2
    keep_every_n_epochs: Optional[int] = 100
    no_train_dir: bool = False
    precision: str = "bf16"  # bf16 | fp32 (each with its own kernels on the card)
    # Accepted so that the JAX package's flag surface parses; it decides
    # nothing: the port runs its kernels on every CUDA tensor and their plain
    # versions on the CPU.
    use_pallas_attention: Optional[bool] = None
    steps_per_call: int = 1  # calls of the step per round of the loop
    limit_steps_per_epoch: Optional[int] = None  # smoke runs
    resume: Optional[str] = None  # "auto" | path | None
    # Overlap checkpoint serialization/writes with the next epoch's compute
    # (utils/checkpoint.py::AsyncCheckpointer; the device-to-host snapshot
    # stays synchronous, because the step updates in place).  The reference
    # saves synchronously (util/misc.py:306-335); off restores that behaviour.
    async_checkpoint: bool = True
    device: str = "cuda"

    @property
    def effective_batch(self) -> int:
        return self.batch_size * self.accum_iter

    @property
    def absolute_lr(self) -> float:
        # blr scaled by effective batch / 256 (reference main_pretrain.py:203-204)
        return self.blr * self.effective_batch / 256.0


def model_config(settings: PretrainSettings) -> MAEConfig:
    """The preset ``settings.model`` at ``settings.precision``: in bf16,
    masked-MSE pretraining rounds the scores to bf16 before the softmax, as
    the JAX recipe does.  The decoder's tokens count as padded to the next
    multiple of 8, as the JAX engine pads them with its kernels on
    (pretrain.py:134-135), which decides where the fusion knobs apply."""
    presets = {
        "mae_vit_base_patch16": MAE_VIT_B16,
    }
    if settings.model not in presets:
        raise ValueError(f"Unknown model preset {settings.model!r}")
    base = presets[settings.model]
    compute = torch.bfloat16 if settings.precision == "bf16" else torch.float32
    encoder = replace(base.encoder, img_size=settings.image_size, compute_dtype=compute,
                      attention_softmax_f32=(compute == torch.float32))
    n_tokens = encoder.num_patches + 1
    return replace(base, encoder=encoder, mask_ratio=settings.mask_ratio,
                   norm_pix_loss=settings.norm_pix_loss,
                   decoder_pad_to=-(-n_tokens // 8) * 8 if n_tokens % 8 else None)


@dataclass
class PretrainState:
    """What a step reads and updates in place."""

    model: MAE
    params: Dict[str, torch.Tensor]    # fp32 masters: the model's own parameters
    params_c: Dict[str, torch.Tensor]  # the compute copy the forward reads
    opt: optim.AdamWState
    lr_scale: Dict[str, float]
    wd_scale: Dict[str, float]


def init_pretrain_state(model: MAE) -> PretrainState:
    params = {name: p.detach() for name, p in model.named_parameters()}
    return PretrainState(
        model=model,
        params=params,
        params_c=compute_copy(params, model.cfg.encoder.compute_dtype),
        opt=optim.adamw_init(params),
        lr_scale=optim.pretrain_lr_scales(params),
        wd_scale=optim.no_weight_decay_scales(params),
    )


def _check_batch(cfg: MAEConfig, images_u8: torch.Tensor, noise: torch.Tensor) -> None:
    if images_u8.dtype != torch.uint8 or images_u8.dim() != 5 or images_u8.shape[0] < 1:
        raise ValueError(f"expected uint8 images (accum, B, H, W, 3), got "
                         f"{images_u8.dtype} {tuple(images_u8.shape)}")
    if tuple(noise.shape) != (*images_u8.shape[:2], cfg.encoder.num_patches):
        raise ValueError(f"noise {tuple(noise.shape)} does not fit images "
                         f"{tuple(images_u8.shape)}")


def loss_and_grads(state: PretrainState, images_u8: torch.Tensor,
                   noise: torch.Tensor) -> tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The mean loss and the mean fp32 gradients over the microbatches of
    ``images_u8`` (accum, B, H, W, 3) uint8 with ``noise`` (accum, B, L).

    Gradients are taken with respect to the compute copy; every parameter
    gets one, the frozen sin-cos tables too (their learning-rate scale is
    0), so the gradient norm counts what the JAX step's counts.
    """
    cfg = state.model.cfg
    _check_batch(cfg, images_u8, noise)
    accum = images_u8.shape[0]
    names = list(state.params_c)
    grads, loss_sum = None, None
    for micro in range(accum):
        leaves = {n: state.params_c[n].detach().requires_grad_() for n in names}
        images = normalize_batch(images_u8[micro], cfg.encoder.compute_dtype)
        loss, _, _ = functional_call(state.model, leaves, (images, noise[micro]))
        micro_grads = [g.float() for g in torch.autograd.grad(loss, list(leaves.values()))]
        if grads is None:  # the JAX step's zeros + g, without the zeros
            grads, loss_sum = micro_grads, loss.detach()
        else:
            torch._foreach_add_(grads, micro_grads)
            loss_sum = loss_sum + loss.detach()
    if accum > 1:
        torch._foreach_mul_(grads, 1.0 / accum)
        loss_sum = loss_sum * (1.0 / accum)
    return loss_sum, dict(zip(names, grads))


def make_pretrain_step(
    cfg: MAEConfig, accum_iter: int, weight_decay: float
) -> Callable[[PretrainState, torch.Tensor, torch.Tensor, float], Dict[str, torch.Tensor]]:
    """Build the train step ``(state, images_u8, noise, lr) -> {loss, grad_norm}``.

    ``images_u8`` is (accum_iter, B, H, W, 3) uint8 and ``noise`` (accum_iter,
    B, L) float, both on the model's device.  The step averages the fp32
    gradients of the microbatches (:func:`loss_and_grads`), then runs AdamW on
    the masters and refreshes the compute copy in one pass
    (``optim.adamw_update_fused``), all in place.  In a process group the
    batch is this rank's rows: the loss and the mean gradient are all-reduced
    by their mean over the ranks before AdamW.
    """

    def step(state: PretrainState, images_u8: torch.Tensor, noise: torch.Tensor,
             lr: float) -> Dict[str, torch.Tensor]:
        if state.model.cfg != cfg or images_u8.shape[0] != accum_iter:
            raise ValueError(f"the step was built for {accum_iter} microbatches of {cfg}")
        loss, grads = loss_and_grads(state, images_u8, noise)
        if is_distributed():
            cross_replica_mean([loss, *grads.values()])
        grad_norm = optim.global_norm(grads)
        optim.adamw_update_fused(
            state.params, state.params_c, grads, state.opt, lr=lr, b1=0.9, b2=0.95,
            weight_decay=weight_decay, lr_scale=state.lr_scale, wd_scale=state.wd_scale,
        )
        return {"loss": loss, "grad_norm": grad_norm}

    return step


def _step_noise(seed: int, epoch: int, step: int, shape, device: torch.device) -> torch.Tensor:
    """One step's masking noise, uniform in [0, 1), from its own generator."""
    gen = torch.Generator(device=device)
    gen.manual_seed(step_seed(seed, epoch, step))
    return torch.rand(shape, generator=gen, device=device)


def checkpoint_payload(state: PretrainState) -> Dict[str, Any]:
    """The JAX engine's payload, ``{"params", "opt": {"step", "mu", "nu"}}``,
    in the JAX layout with numpy leaves: the masters and both moments through
    ``jax_from_mae_state_dict`` (the moments are elementwise, so the same
    transposes apply), the step a 0-d int32 array as the JAX state holds it."""
    cfg = state.model.cfg
    return {
        "params": jax_from_mae_state_dict(state.params, cfg),
        "opt": {
            "step": np.asarray(state.opt.step, dtype=np.int32),
            "mu": jax_from_mae_state_dict(state.opt.mu, cfg),
            "nu": jax_from_mae_state_dict(state.opt.nu, cfg),
        },
    }


def restore_state(state: PretrainState, payload: Mapping[str, Any]) -> None:
    """Write a :func:`checkpoint_payload` (from either package) into
    ``state`` in place.

    The masters are the model's own parameters, the compute copy aliases
    them in fp32 and the AdamW kernel's wrapper keeps their addresses
    (``state.opt.cache``), so every tensor is copied into, never rebound;
    the compute copy is then refreshed from the masters."""
    cfg = state.model.cfg
    opt = payload["opt"]
    for target, tree in ((state.params, payload["params"]), (state.opt.mu, opt["mu"]),
                         (state.opt.nu, opt["nu"])):
        optim.copy_into(target, mae_state_dict_from_jax(tree, cfg))
    optim.refresh_compute_copy(state.params, state.params_c)
    state.opt.step = int(np.asarray(opt["step"]))


def find_resume_path(resume: Optional[str], ckpt_dir: Path) -> Optional[Path]:
    """``"auto"``: the ``last.ckpt`` pointer, else the numerically greatest
    ``checkpoint-<n>.ckpt`` (lexicographic order would resume checkpoint-99
    over checkpoint-119 and silently discard epochs), else None.  Any other
    non-empty value is a path."""
    if resume == "auto":
        pointer = ckpt_dir / "last.ckpt"
        if pointer.exists():
            return pointer
        candidates = sorted(ckpt_dir.glob("checkpoint-*.ckpt"),
                            key=lambda p: int(p.stem.split("-")[-1]))
        return candidates[-1] if candidates else None
    return Path(resume) if resume else None


def run_pretraining(settings: PretrainSettings) -> Dict[str, Any]:
    """Full pretraining loop; returns the final summary dict (the last
    epoch's record, or ``{"interrupted": True, "epoch": e}`` after a
    SIGTERM or SIGINT saved epoch ``e``).

    Writes ``<output_dir>/pretrain.{log,jsonl}`` and TensorBoard scalars
    through ``RunLogger``, and checkpoints under ``<output_dir>/ckpts``;
    raises ``FloatingPointError`` on a non-finite loss after saving.  The
    loader decodes with PIL, so the host needs it.  In a process group every
    rank calls this with the same settings, on ``settings.device`` as
    :func:`~..parallel.multihost.local_device` places it.
    """
    set_determinism(settings.seed)
    device = local_device(settings.device)
    primary = is_primary()
    rank, ranks = process_index(), build_mesh().data
    if settings.batch_size % ranks:
        raise ValueError(f"batch_size {settings.batch_size} does not divide over {ranks} ranks")
    cfg = model_config(settings)
    output_dir = Path(settings.output_dir)
    ckpt_dir = output_dir / "ckpts"
    if primary:
        ckpt_dir.mkdir(parents=True, exist_ok=True)
    logger = RunLogger(output_dir, "pretrain", primary=primary)

    loader = PretrainLoader(
        ImageFolderIndex(settings.data_root, no_train_dir=settings.no_train_dir),
        batch_size=settings.effective_batch // ranks,
        image_size=settings.image_size,
        seed=settings.seed,
        num_workers=settings.num_workers,
        process_index=rank,
        process_count=ranks,
    )
    steps_per_epoch = len(loader)
    if settings.limit_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, settings.limit_steps_per_epoch)
    total_steps = steps_per_epoch * settings.epochs
    schedule = warmup_cosine(settings.absolute_lr, total_steps,
                             settings.warmup_epochs * steps_per_epoch, settings.min_lr)

    model = MAE(cfg, torch.Generator().manual_seed(settings.seed)).to(device)
    state = init_pretrain_state(model)
    start_epoch = 0

    # ---- resume --------------------------------------------------------
    barrier()  # rank 0's files are complete before any rank reads them
    resume_path = find_resume_path(settings.resume, ckpt_dir)
    if resume_path is not None and resume_path.exists():
        restored = load_checkpoint(resume_path)
        restore_state(state, restored["payload"])
        start_epoch = int(restored["meta"].get("epoch", -1)) + 1
        logger.text(f"Resumed from {resume_path} at epoch {start_epoch}")
    if is_distributed():  # every rank starts from rank 0's masters
        replicate(state.params)
        optim.refresh_compute_copy(state.params, state.params_c)

    steps_per_call = max(1, int(settings.steps_per_call))
    train_step = make_pretrain_step(cfg, settings.accum_iter, settings.weight_decay)

    # ---- signal handling: save and exit --------------------------------
    interrupted = {"flag": False}

    def _handler(signum, frame):
        interrupted["flag"] = True

    old_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old_handlers[sig] = signal.signal(sig, _handler)
        except ValueError:
            pass  # not in main thread

    checkpointer = AsyncCheckpointer() if settings.async_checkpoint else None

    def save_epoch(epoch: int) -> Path:
        path = ckpt_dir / f"checkpoint-{epoch}.ckpt"
        if not primary:
            return path
        payload = checkpoint_payload(state)
        meta = {
            "epoch": epoch,
            "settings": dataclasses.asdict(settings),
            "model": settings.model,
        }

        def _cleanup():
            cleanup_checkpoints(
                ckpt_dir,
                keep_last=settings.keep_last,
                keep_every_n_epochs=settings.keep_every_n_epochs,
                primary=primary,
            )

        if checkpointer is not None:
            # Host snapshot now (the step updates in place), serialize+write+
            # pointer+retention on the writer thread, overlapped with the
            # next epoch's compute.
            checkpointer.save(
                path, payload, meta,
                pointer=ckpt_dir / "last.ckpt", cleanup=_cleanup, primary=primary,
            )
            return path
        save_checkpoint(path, payload, meta, primary=primary)
        update_pointer(ckpt_dir / "last.ckpt", path, primary=primary)
        _cleanup()
        return path

    throughput = Throughput()
    summary: Dict[str, Any] = {}
    step_global = start_epoch * steps_per_epoch
    accum, micro = settings.accum_iter, settings.batch_size // ranks
    noise_shape = (accum, settings.batch_size, cfg.encoder.num_patches)

    def one_step(raw: np.ndarray, epoch: int, it: int, lr: float) -> Dict[str, torch.Tensor]:
        images = torch.from_numpy(raw.reshape(accum, micro, *raw.shape[1:])).to(device)
        # The step's global noise; this rank's rows of each microbatch.
        noise = _step_noise(settings.seed, epoch, it, noise_shape, device)
        noise = noise[:, rank * micro:(rank + 1) * micro]
        return train_step(state, images, noise, lr)

    try:
        for epoch in range(start_epoch, settings.epochs):
            loader.set_epoch(epoch)
            epoch_loss = 0.0
            epoch_log_points = 0
            steps_since_log = 0
            t0 = time.perf_counter()
            last_save_time = time.perf_counter()
            iterator = iter(loader)
            it = 0
            try:
                while True:
                    # Collect steps_per_call batches for one round of calls.
                    pending: list = []
                    while len(pending) < steps_per_call and it + len(pending) < steps_per_epoch:
                        try:
                            pending.append(next(iterator))
                        except StopIteration:
                            break
                    if not pending:
                        break
                    chunk = len(pending)
                    # Each call samples the per-iteration cosine at its own
                    # global index and draws the noise of its own step.
                    lrs = [schedule(step_global + j) for j in range(chunk)]
                    step_metrics = [one_step(raw, epoch, it + j, lrs[j])
                                    for j, raw in enumerate(pending)]
                    metrics = dict(step_metrics[-1])
                    if steps_per_call > 1 and chunk == steps_per_call:
                        # The JAX engine's fused dispatch reports the mean loss.
                        metrics["loss"] = torch.stack([m["loss"] for m in step_metrics]).mean()
                    lr = lrs[-1]
                    step_global += chunk
                    steps_since_log += chunk
                    if (it // steps_per_call) % max(
                        1, settings.log_interval // steps_per_call
                    ) == 0:
                        loss_value = float(metrics["loss"])
                        if not math.isfinite(loss_value):
                            logger.text(f"FATAL: non-finite loss {loss_value} at step {step_global}")
                            save_epoch(epoch)
                            raise FloatingPointError(f"Loss is {loss_value}, stopping")
                        grad_norm_value = float(metrics["grad_norm"])
                        if not math.isfinite(grad_norm_value):
                            logger.text(f"WARNING: non-finite grad norm at step {step_global}")
                        epoch_loss += loss_value
                        epoch_log_points += 1
                        # Actual steps since the last log: the cadence of K
                        # calls a round is chunk-quantized.
                        rate = throughput.tick(settings.effective_batch * steps_since_log)
                        steps_since_log = 0
                        logger.scalar("train/loss", loss_value, step_global)
                        logger.scalar("train/lr", lr, step_global)
                        logger.scalar("train/grad_norm", grad_norm_value, step_global)
                        if rate:
                            logger.scalar("train/images_per_sec", rate, step_global)
                    if any_rank(interrupted["flag"]):
                        logger.text("Signal received: checkpointing and exiting")
                        save_epoch(epoch)
                        return {"interrupted": True, "epoch": epoch}
                    if (
                        settings.save_freq_mins
                        and time.perf_counter() - last_save_time > settings.save_freq_mins * 60.0
                    ):
                        # time-based mid-epoch checkpoint (reference
                        # engine_pretrain.py:90-93)
                        save_epoch(epoch)
                        last_save_time = time.perf_counter()
                    it += chunk
                    if it >= steps_per_epoch:
                        break
            finally:
                iterator.close()  # stops the loader's decode thread on every exit

            mean_loss = epoch_loss / max(1, epoch_log_points)
            epoch_record = {
                "epoch": epoch,
                "train_loss": mean_loss,
                "lr": schedule(step_global),
                "epoch_time_s": time.perf_counter() - t0,
            }
            logger.json_line(epoch_record)
            logger.text(f"epoch {epoch}: loss {mean_loss:.4f}")
            if (epoch + 1) % settings.save_freq_epochs == 0 or epoch == settings.epochs - 1:
                save_epoch(epoch)
            summary = epoch_record
    finally:
        # Join the in-flight write on every exit path (normal, signal
        # save-and-exit, non-finite-loss abort), and restore the signal
        # handlers and close the logger even when that join raises (the
        # JAX engine skips both then); its error then propagates.
        try:
            if checkpointer is not None:
                checkpointer.wait()
        finally:
            for sig, handler in old_handlers.items():
                signal.signal(sig, handler)
            logger.close()

    # The final epoch was already checkpointed inside the loop (the
    # `epoch == settings.epochs - 1` branch of the save condition).
    return summary


def cli_main(argv: Optional[list] = None) -> Dict[str, Any]:
    """``python -m ssl4polyp_tpu_torch.training.pretrain --data-root ...``:
    every :class:`PretrainSettings` field as a flag; runs on the card unless
    ``--device cpu`` is given.  Returns :func:`run_pretraining`'s summary.
    Under ``torchrun`` every rank runs it (``parallel.multihost``)."""
    from ..utils.cli import parse_into_dataclass

    settings = parse_into_dataclass(
        PretrainSettings, argv, description="MAE pretraining (PyTorch, CUDA)"
    )
    initialize_multihost(backend="gloo" if torch.device(settings.device).type == "cpu" else None)
    return run_pretraining(settings)


if __name__ == "__main__":
    cli_main()
