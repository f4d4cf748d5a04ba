"""Training steps: CE fine-tune, knowledge distillation and the audio-visual
step, plus the teacher-forced eval steps.

Port of ``whisper_flamingo_tpu/training/steps.py``. Each ``make_*`` function returns
``step(state, batch) -> (state, metrics)`` (the KD steps take the frozen
teacher model as a second argument):

- family A (audio-only fine-tune): teacher-forced CE with -100 ignore
  masking; ``freeze_encoder`` detaches the encoder features;
- family C (Trans-ASR): conditioning streams ``xt`` through the gated
  x-attn, CE;
- family D (TransKD): a frozen teacher and a student,
  ``loss = alpha * CE + beta * T^2 * KL(teacher || student)``;
- family E (prompt distillation): the teacher reads the prompted token
  stream, the student the unprompted one, the teacher's logits moved onto
  the student's label positions;
- the audio-visual step (``make_av_train_step``, ``step(state, video,
  batch, generator)``): the AV-HuBERT trunk's features as the gated
  x-attn stream, the Whisper encoder frozen (forward only, autograd on but
  nothing to record), modality dropout from one draw of the step's
  ``torch.Generator`` per batch.

The step runs the forward in the compute dtype over the fp32 masters,
backpropagates (through the flash64 backward kernel when the encoder
trains), and updates the parameters in place through the state's
optimizer (the analogue of JAX's donated state). Metrics are device
tensors; reading one waits for the step.

Under a mesh (a model sliced by :func:`..parallel.mesh.shard_params`, a
batch of this rank's rows from :func:`..parallel.mesh.shard_batch`) every
step computes what one device computes on the global batch, as JAX's
``pjit`` did: each masked mean is the global one (this rank's masked sum
times ``n_data`` over the label count summed over the data axis, so the
ranks' losses, and the gradients the optimizer averages over the data
axis, average to the global mean), the reported loss is that mean, the CE
runs vocabulary-parallel on split logits (:func:`..parallel.tp.vocab_parallel_nll`)
and the distillation losses read the gathered full-vocabulary logits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from .. import profiling
from ..models.avhubert import avhubert_encoder_apply
from ..models.dims import ModelDimensions
from ..models.whisper import Whisper, decoder_apply, encoder_apply
from ..parallel.mesh import DATA_AXIS
from ..parallel.tp import vocab_parallel_nll
from .optim import Mask, WhisperOptimizer

LABEL_PAD = -100
_FP32_CONSUMED = {"decoder.token_embedding.weight", "decoder.positional_embedding"}


@dataclass
class TrainState:
    """The model (the fp32 masters), its optimizer with the schedule, and
    the step: the count of train-step calls (micro-steps under gradient
    accumulation)."""

    model: Whisper
    optimizer: WhisperOptimizer
    step: int = 0

    @staticmethod
    def create(model: Whisper, tx: WhisperOptimizer) -> "TrainState":
        return TrainState(model=model, optimizer=tx, step=0)


def cast_frozen_bf16(model: Whisper, trainable_mask: Mask) -> Whisper:
    """Store frozen parameters in bf16 (trainable masters stay fp32), in
    place. With bf16 compute the matmul and conv weights are cast at use
    anyway, so the forward is bit-identical while the frozen weights take
    half the memory. Parameters consumed at fp32 stay fp32: LayerNorm
    weights and biases and the token and positional embeddings."""
    for mod_name, mod in model.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            full = f"{mod_name}.{name}" if mod_name else name
            if trainable_mask[full] or p.dtype != torch.float32:
                continue
            if isinstance(mod, torch.nn.LayerNorm) or full in _FP32_CONSUMED:
                continue
            p.data = p.data.to(torch.bfloat16)
    return model


def _mesh(model):
    return getattr(model, "mesh", None)


def _count(mask: torch.Tensor, mesh) -> torch.Tensor:
    """The masked mean's divisor: the label count, clamped at 1; under data
    ranks the global count over ``n_data`` (this rank's share)."""
    if mesh is None or mesh.n_data == 1:
        return torch.clamp(mask.sum(), min=1)
    total = mesh.all_reduce(mask.sum().to(torch.float32), DATA_AXIS)
    return torch.clamp(total, min=1) / mesh.n_data


def global_mean(loss: torch.Tensor, mesh) -> torch.Tensor:
    """A loss of :func:`ce_loss` / :func:`kd_kl_loss` as the global masked
    mean: the ranks' values averaged over the data axis (detached)."""
    loss = loss.detach()
    if mesh is None or mesh.n_data == 1:
        return loss
    return mesh.all_reduce(loss.clone(), DATA_AXIS) / mesh.n_data


def ce_loss(logits: torch.Tensor, labels: torch.Tensor, mesh=None, vocab_tp=None) -> torch.Tensor:
    """Mean CE over non-ignored positions (``ignore_index=-100``). Under a
    mesh, this rank's share of the global mean (:func:`global_mean` reads
    it); with ``vocab_tp`` (the mesh of a vocabulary-split decoder) the
    logits are this rank's vocabulary block."""
    mask = labels != LABEL_PAD
    safe = torch.where(mask, labels, torch.zeros_like(labels))
    if vocab_tp is not None:
        nll = vocab_parallel_nll(logits.float(), safe, vocab_tp)
    else:
        logprobs = F.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logprobs, -1, safe.unsqueeze(-1)).squeeze(-1)
    return torch.sum(nll * mask) / _count(mask, mesh)


def kd_kl_loss(
    student_logits: torch.Tensor, teacher_logits: torch.Tensor, labels: torch.Tensor,
    temperature: float, mesh=None,
) -> torch.Tensor:
    """T^2-scaled KL(teacher || student), masked-mean over label positions
    (full-vocabulary logits; under a mesh this rank's share, as
    :func:`ce_loss`)."""
    t = temperature
    s = F.log_softmax(student_logits.float() / t, dim=-1)
    p = F.softmax(teacher_logits.float() / t, dim=-1)
    logp = F.log_softmax(teacher_logits.float() / t, dim=-1)
    kl = torch.sum(p * (logp - s), dim=-1)
    mask = labels != LABEL_PAD
    return (t * t) * torch.sum(kl * mask) / _count(mask, mesh)


def to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors on ``device`` (token ids as int64);
    host-only fields (strings, lists) are dropped."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, (list, tuple, str)):
            continue
        t = torch.as_tensor(v)
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device, non_blocking=True)
    return out


def _apply_update(state: TrainState, loss: torch.Tensor) -> TrainState:
    if loss.requires_grad:  # else nothing trains (JAX's all-zero updates)
        with profiling.span("train.backward"):
            loss.backward()
    state.optimizer.step()
    state.step += 1
    return state


def make_ce_train_step(
    dims: ModelDimensions, *, freeze_encoder: bool = False, use_xt: bool = False,
    dtype: torch.dtype = torch.bfloat16, remat=True,
) -> Callable:
    """CE fine-tune step (families A/B/C). ``use_xt`` feeds the batch's
    conditioning streams ``xt`` to the gated x-attn."""

    def step(state: TrainState, batch: Dict[str, Any]):
        with profiling.span("train.step"):
            with profiling.span("train.forward"):
                model = state.model
                mesh = _mesh(model)
                b = to_device(batch, model.device)
                feats = encoder_apply(model, dims, b["input_ids"], dtype=dtype, remat=remat)
                if freeze_encoder:
                    feats = feats.detach()
                logits, _ = decoder_apply(
                    model, dims, b["dec_input_ids"], feats, xt=b.get("xt") if use_xt else None,
                    dtype=dtype, remat=remat, gather_logits=False,
                )
                loss = ce_loss(logits, b["labels"], mesh, getattr(model.decoder, "tp", None))
            return _apply_update(state, loss), {"loss": global_mean(loss, mesh)}

    return step


def make_kd_train_step(
    dims: ModelDimensions, *, alpha: float = 0.8, beta: float = 1.0,
    temperature: float = 2.0, freeze_student_encoder: bool = False,
    share_teacher_features: bool = False, teacher_uses_xt: bool = True,
    teacher_dims: Optional[ModelDimensions] = None, dtype: torch.dtype = torch.bfloat16,
    remat=True,
) -> Callable:
    """TransKD distillation step (family D): ``step(state, teacher, batch)``.
    ``share_teacher_features`` reuses the teacher's encoder output for a
    frozen student encoder; ``teacher_dims`` allows a larger teacher with
    the same vocabulary."""
    teacher_dims = teacher_dims or dims
    if share_teacher_features and teacher_dims.n_audio_state != dims.n_audio_state:
        raise ValueError(
            "share_teacher_features needs matching encoder widths "
            f"(teacher {teacher_dims.n_audio_state} vs student {dims.n_audio_state})"
        )
    if teacher_dims.n_vocab != dims.n_vocab:
        raise ValueError("KD requires a shared vocabulary")

    def step(state: TrainState, teacher: Whisper, batch: Dict[str, Any]):
        with profiling.span("train.step"):
            with profiling.span("train.forward"):
                model = state.model
                mesh = _mesh(model)
                b = to_device(batch, model.device)
                with torch.no_grad():
                    teacher_feats = encoder_apply(teacher, teacher_dims, b["input_ids"],
                                                  dtype=dtype)
                    teacher_logits, _ = decoder_apply(
                        teacher, teacher_dims, b["dec_input_ids"], teacher_feats,
                        xt=b.get("xt") if teacher_uses_xt else None, dtype=dtype,
                    )
                if share_teacher_features and freeze_student_encoder:
                    feats = teacher_feats
                else:
                    feats = encoder_apply(model, dims, b["input_ids"], dtype=dtype, remat=remat)
                    if freeze_student_encoder:
                        feats = feats.detach()
                logits, _ = decoder_apply(model, dims, b["dec_input_ids"], feats, dtype=dtype,
                                          remat=remat)
                ce = ce_loss(logits, b["labels"], mesh)
                kd = kd_kl_loss(logits, teacher_logits, b["labels"], temperature, mesh)
                loss = alpha * ce + beta * kd
            state = _apply_update(state, loss)
            return state, {"loss": global_mean(loss, mesh), "ce": global_mean(ce, mesh),
                           "kd": global_mean(kd, mesh)}

    return step


def _scatter_rows(dest: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """dest[b, idx[b, k]] = src[b, k] per batch row (a new tensor)."""
    rows = torch.arange(dest.shape[0], device=dest.device)[:, None]
    out = dest.clone()
    out[rows, idx] = src
    return out


def make_prompt_kd_train_step(
    dims: ModelDimensions, *, alpha: float = 0.8, beta: float = 1.0,
    temperature: float = 2.0, freeze_student_encoder: bool = False,
    dtype: torch.dtype = torch.bfloat16, remat=True,
) -> Callable:
    """Prompt-distillation step (family E): ``step(state, teacher, batch)``.
    The teacher's logits at its k-th valid label position land on the
    student's k-th valid label position (both valid regions are the
    non-pad labels, laid out alike by the collator's asymmetric padding)."""

    def step(state: TrainState, teacher: Whisper, batch: Dict[str, Any]):
        with profiling.span("train.step"):
            with profiling.span("train.forward"):
                model = state.model
                mesh = _mesh(model)
                b = to_device(batch, model.device)
                with torch.no_grad():
                    feats_t = encoder_apply(teacher, dims, b["input_ids"], dtype=dtype)
                    teacher_logits, _ = decoder_apply(
                        teacher, dims, b["teacher_dec_input_ids"], feats_t, dtype=dtype
                    )
                    t_valid = b["teacher_labels"] != LABEL_PAD
                    s_valid = b["labels"] != LABEL_PAD
                    # valid positions first, in order (a stable sort of ~valid)
                    t_idx = torch.sort((~t_valid).to(torch.uint8), dim=1, stable=True).indices
                    s_idx = torch.sort((~s_valid).to(torch.uint8), dim=1, stable=True).indices
                    ts = b["labels"].shape[1]
                    gathered = torch.gather(
                        teacher_logits, 1,
                        t_idx[:, :ts, None].expand(-1, -1, teacher_logits.shape[-1]),
                    )
                    aligned = _scatter_rows(torch.zeros_like(gathered), s_idx[:, :ts], gathered)
                feats = encoder_apply(model, dims, b["input_ids"], dtype=dtype, remat=remat)
                if freeze_student_encoder:
                    feats = feats.detach()
                logits, _ = decoder_apply(model, dims, b["dec_input_ids"], feats, dtype=dtype,
                                          remat=remat)
                ce = ce_loss(logits, b["labels"], mesh)
                kd = kd_kl_loss(logits, aligned, b["labels"], temperature, mesh)
                loss = alpha * ce + beta * kd
            state = _apply_update(state, loss)
            return state, {"loss": global_mean(loss, mesh), "ce": global_mean(ce, mesh),
                           "kd": global_mean(kd, mesh)}

    return step


def _apply_av_encoder(video, batch: Dict[str, torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """The trunk over the batch's ``video`` (and ``fbank`` with an audio
    trunk), with the per-row modality masks of a mixed batch
    (``video_lens`` / ``fbank_lens`` of 0 mark a row without that stream);
    a row with no modality at all gets zero conditioning, not the
    conv-bias / LayerNorm output of its zero padding."""
    cfg = video.cfg
    vlens, flens = batch.get("video_lens"), batch.get("fbank_lens")
    use_audio = cfg.audio_feat_dim is not None
    vfeats = avhubert_encoder_apply(
        video, cfg, video=batch["video"], audio=batch.get("fbank") if use_audio else None,
        video_mask=(vlens > 0) if vlens is not None else None,
        audio_mask=(flens > 0) if (use_audio and flens is not None) else None,
        dtype=dtype,
    )
    if vlens is not None:
        has_any = vlens > 0
        if use_audio and flens is not None and "fbank" in batch:
            has_any = has_any | (flens > 0)
        vfeats = vfeats * has_any.to(vfeats.dtype)[:, None, None]
    return vfeats


def make_av_train_step(
    dims: ModelDimensions, *, prob_av: float = 0.5, prob_a: float = 0.25,
    freeze_video: bool = True, dtype: torch.dtype = torch.bfloat16, remat=True,
) -> Callable:
    """Audio-visual gated x-attn step (Whisper-Flamingo step 2: the Whisper
    encoder and the AV-HuBERT trunk frozen, the gated layers learn):
    ``step(state, video, batch, generator)`` with ``video`` the trunk
    (:class:`..models.avhubert.VideoEncoder`).

    Modality dropout: one ``u`` per batch from ``generator``; both streams
    if u < prob_av, audio only (the video features zeroed) if u < prob_av +
    prob_a, video only (the encoder features zeroed) otherwise; counters
    ``train.av_both``, ``train.av_audio``, ``train.av_video`` count the draws.
    The frozen forwards (span ``train.frozen``) run with autograd on: no
    parameter or input of theirs requires grad, so they record no graph and
    keep no activation, and the encoder's flash64 takes its inference
    forward (no lse, no backward); the remat wrapper runs each block once.
    On the H100 at the step-2 cell's widths and b16 they took the same
    device time, host time and memory as under ``torch.no_grad()``, so
    nothing wraps them. Their outputs are detached (the trunk's under
    ``freeze_video``). A batch with ``fbank`` and a trunk with an audio trunk
    feeds both streams to it (``--modalities avsr``)."""

    def step(state: TrainState, video, batch: Dict[str, Any], generator: torch.Generator):
        with profiling.span("train.step"):
            with profiling.span("train.forward"):
                u = float(torch.rand((), generator=generator))
                drop_video = prob_av <= u < prob_av + prob_a
                drop_audio = u >= prob_av + prob_a
                profiling.count("train.av_video" if drop_audio else
                                "train.av_audio" if drop_video else "train.av_both")
                model = state.model
                b = to_device(batch, model.device)
                with profiling.span("train.frozen"):
                    vfeats = _apply_av_encoder(video, b, dtype)
                    if freeze_video:
                        vfeats = vfeats.detach()
                    feats = encoder_apply(model, dims, b["input_ids"], dtype=dtype,
                                          remat=remat).detach()
                if drop_video:
                    vfeats = torch.zeros_like(vfeats)
                if drop_audio:
                    feats = torch.zeros_like(feats)
                logits, _ = decoder_apply(model, dims, b["dec_input_ids"], feats, xt=vfeats[None],
                                          dtype=dtype, remat=remat, gather_logits=False)
                mesh = _mesh(model)
                loss = ce_loss(logits, b["labels"], mesh, getattr(model.decoder, "tp", None))
            return _apply_update(state, loss), {"loss": global_mean(loss, mesh)}

    return step


def make_av_eval_step(dims: ModelDimensions, *, dtype: torch.dtype = torch.float32) -> Callable:
    """Teacher-forced AV eval: ``step(video, model, batch) -> (loss, argmax
    tokens)``; the video stream goes through the gated x-attn as in
    training, with no modality dropout. Bind ``video`` with
    ``functools.partial`` for the Trainer's ``(model, batch)`` interface."""

    @torch.no_grad()
    def step(video, model: Whisper, batch: Dict[str, Any]):
        b = to_device(batch, model.device)
        vfeats = _apply_av_encoder(video, b, dtype)
        feats = encoder_apply(model, dims, b["input_ids"], dtype=dtype)
        logits, _ = decoder_apply(model, dims, b["dec_input_ids"], feats, xt=vfeats[None],
                                  dtype=dtype)
        mesh = _mesh(model)
        return global_mean(ce_loss(logits, b["labels"], mesh), mesh), torch.argmax(logits, dim=-1)

    return step


def make_eval_step(
    dims: ModelDimensions, *, use_xt: bool = False, dtype: torch.dtype = torch.float32,
) -> Callable:
    """Teacher-forced eval: ``step(model, batch) -> (loss, argmax tokens)``,
    without autograd; under a mesh the loss is the global mean and the
    tokens are this rank's rows."""

    @torch.no_grad()
    def step(model: Whisper, batch: Dict[str, Any]):
        b = to_device(batch, model.device)
        feats = encoder_apply(model, dims, b["input_ids"], dtype=dtype)
        logits, _ = decoder_apply(
            model, dims, b["dec_input_ids"], feats, xt=b.get("xt") if use_xt else None,
            dtype=dtype,
        )
        mesh = _mesh(model)
        return global_mean(ce_loss(logits, b["labels"], mesh), mesh), torch.argmax(logits, dim=-1)

    return step
