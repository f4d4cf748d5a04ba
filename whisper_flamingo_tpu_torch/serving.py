"""Serving: fixed-batch transcription with request padding, and continuous
batching with per-request token budgets.

Port of ``whisper_flamingo_tpu/serving.py``:

- :class:`BatchTranscriber` pads a list of utterances to one of a few batch
  sizes, decodes each batch as one :class:`..decoding.DecodingTask` run and
  unpads; ``draft_model`` switches greedy decoding to speculative decoding
  (:mod:`.speculative`); ``transcribe_long`` decodes the 30 s windows of
  one recording as one batch; ``transcribe_files`` runs the long-form
  driver per file.
- :class:`ContinuousBatcher` serves a fixed number of slots: each slot
  holds one request at its own length (per-row cache offsets, the
  decode-attention kernel's per-row mode), the slots advance together, and
  a finished slot takes the next request from the queue, so throughput
  follows the total of tokens and not slots x the longest request.
  ``poll`` is the incremental server API (with ``pipeline``,
  ``stop_on_finish`` and ``drain_chunk``); ``run_queued`` drains the queue
  from a pool of requests prefilled together (``pool_cap`` bounds it,
  ``sort_admission`` admits the longest budgets first). Greedy only, int8
  or unquantized (int8kv raises, as in JAX), optionally speculative.
  Results equal per-utterance ``decode`` token for token.

The JAX package compiled these loops into XLA programs
(``_make_cb_programs``); here they are host loops over the port's decoder
on the model's device. A chunk runs up to ``chunk`` steps with no wait on
the step just queued: after each step the slots' flags are copied to the
host without blocking, and the loop reads the flags of the step before,
so a chunk ends one step after its condition at most (a finished row
takes that step as a no-op). ``pipeline`` harvests chunk k-1's results,
copied without blocking, while chunk k runs. ``run_queued`` refills a
finished slot from the pool between two steps, at the same one-step lag.

Not carried, each machinery of XLA: the compile buckets (the prefill takes
exactly the requests it is given, not a power-of-two batch), buffer
donation, and the ahead-of-traffic compilation; :meth:`ContinuousBatcher.
warmup` stays as the place where the kernels are built and the weights
prepared, on a scratch state.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import profiling
from .audio import N_SAMPLES, load_audio, log_mel_spectrogram, pad_or_trim
from .decoding import DecodingOptions, DecodingResult, DecodingTask, _apply_filters, _features
from .models.whisper import decoder_apply
from .speculative import SpeculativeDecodingTask, check_draft, draft_params, make_spec_round
from .utils import compression_ratio, resolve_device

State = Dict[str, object]
_ROW_KEYS = ("tokens", "lens", "caps", "finished", "sum_logprobs", "no_speech_probs")


@dataclass
class BatchTranscriber:
    """Fixed-batch decoding with request padding on the model's device.

    ``draft_model`` switches greedy decoding to speculative decoding
    (:class:`.speculative.SpeculativeDecodingTask`): token-identical output,
    fewer verifier passes."""

    model: object
    options: DecodingOptions = field(default_factory=lambda: DecodingOptions(
        language="en", without_timestamps=True
    ))
    batch_sizes: Sequence[int] = (1, 4, 8, 16)
    draft_model: object = None
    draft_len: int = 4

    def __post_init__(self):
        self.device = resolve_device(self.model.device)
        self._tasks = {}

    def _task(self) -> DecodingTask:
        key = (self.options,)
        if key not in self._tasks:
            if self.draft_model is not None:
                self._tasks[key] = SpeculativeDecodingTask(
                    self.model, self.draft_model, self.options, draft_len=self.draft_len
                )
            else:
                self._tasks[key] = DecodingTask(self.model, self.options)
        return self._tasks[key]

    def _pick_batch(self, n: int) -> int:
        for b in sorted(self.batch_sizes):
            if n <= b:
                return b
        return max(self.batch_sizes)

    def warmup(self) -> None:
        """Run every batch size once on silence: builds the kernels and the
        decode copy of the weights before traffic."""
        for b in self.batch_sizes:
            mel = torch.zeros((b, self.model.dims.n_mels, 3000))
            self._task().run(mel)

    def transcribe_segments(self, waveforms: Sequence[np.ndarray]) -> List[DecodingResult]:
        """Decode a list of <= 30 s waveforms; one result each, in order."""
        results: List[DecodingResult] = []
        i = 0
        while i < len(waveforms):
            b = self._pick_batch(len(waveforms) - i)
            chunk = list(waveforms[i: i + b])
            n_real = len(chunk)
            while len(chunk) < b:  # pad the batch with silence
                chunk.append(np.zeros(16000, np.float32))
            padded = np.stack([np.asarray(pad_or_trim(np.asarray(w, np.float32), N_SAMPLES))
                               for w in chunk])
            mel = log_mel_spectrogram(padded, n_mels=self.model.dims.n_mels, device=self.device)
            results.extend(self._task().run(mel)[:n_real])
            i += n_real
        return results

    def transcribe_long(self, audio: np.ndarray) -> str:
        """Long audio as ONE decode batch of its 30 s windows (windows
        independent: no prompt chaining)."""
        audio = np.asarray(audio, np.float32)
        n_windows = max(1, -(-len(audio) // N_SAMPLES))
        windows = [audio[i * N_SAMPLES: (i + 1) * N_SAMPLES] for i in range(n_windows)]
        results = self.transcribe_segments(windows)
        return "".join(r.text if r.text.startswith(" ") else " " + r.text
                       for r in results).strip()

    def transcribe_files(self, paths: Sequence[str], **transcribe_kwargs):
        """Long-form transcription per file, with the full sequential driver
        (prompt chaining, timestamp segmentation)."""
        from .transcribe import transcribe

        return [transcribe(self.model, load_audio(p), language=self.options.language,
                           **transcribe_kwargs) for p in paths]


class _FlagRing:
    """Device flags copied to the host without blocking: :meth:`push` after
    step i, :meth:`read` of step i-1 waits only for that step's copy."""

    def __init__(self, n: int, device: torch.device):
        self._cuda = device.type == "cuda"
        self._host = [torch.empty(n, dtype=torch.bool, pin_memory=self._cuda) for _ in range(2)]
        self._events: List[Optional[torch.cuda.Event]] = [None, None]

    def push(self, i: int, flags: torch.Tensor) -> None:
        self._host[i % 2].copy_(flags, non_blocking=True)
        if self._cuda:
            event = torch.cuda.Event()
            event.record()
            self._events[i % 2] = event

    def read(self, i: int) -> List[bool]:
        event = self._events[i % 2]
        if event is not None:
            event.synchronize()
        return self._host[i % 2].tolist()


class ContinuousBatcher:
    """Continuous-batching greedy decode: finished slots refill mid-flight.

    ``slots`` requests decode side by side at their own lengths; ``chunk``
    steps run per :meth:`poll` while requests wait (``drain_chunk``, 4 x
    chunk by default, once the queue is empty); ``stop_on_finish`` ends a
    chunk when a slot finishes while requests wait; ``pipeline`` harvests
    the previous chunk's results while this one runs. :meth:`run_queued`
    drains the queue from a prefilled pool instead. ``draft_model`` makes
    each step a speculative round (``draft_len`` drafted tokens).
    """

    def __init__(self, model, options: Optional[DecodingOptions] = None, slots: int = 8,
                 chunk: int = 16, draft_model=None, draft_len: int = 4, pipeline: bool = True,
                 stop_on_finish: bool = False, drain_chunk: Optional[int] = None):
        self.device = resolve_device(model.device)
        self.model = model
        self.draft_model = draft_model
        self.draft_len = draft_len
        self.options = options or DecodingOptions(language="en", without_timestamps=True)
        if self.options.beam_size is not None or self.options.best_of is not None:
            raise ValueError("continuous batching is greedy-only")
        if self.options.temperature != 0:
            raise ValueError("continuous batching requires temperature=0")
        if self.options.language is None:
            raise ValueError("continuous batching needs a fixed language")
        if self.options.quantize == "int8kv":
            # the slot cache has no int8 self-cache layout; int8kv is the
            # beam serving mode, and the batcher is greedy-only
            raise ValueError(
                "continuous batching supports quantize='int8' only; 'int8kv' (int8 decode "
                "self cache) is not implemented for the slot cache"
            )
        if draft_model is not None:
            check_draft(model, draft_model)
        self.slots = slots
        self.chunk = chunk
        self.drain_chunk = drain_chunk if drain_chunk is not None else 4 * chunk
        self.stop_on_finish = stop_on_finish
        self.pipeline = pipeline
        # the decode set-up (the verifier's decode copy, caches, prefill,
        # first token) and the option plumbing (initial tokens, filters)
        self._task = DecodingTask(model, self.options)
        # a speculative slot's K draft slots past max_len
        self._k = K = draft_len if draft_model is not None else 0
        # one column past the last write: a cap-finished row's no-op write
        # (K+1 EOTs at offset max_len) stays off its last token
        self._buf_w = self._task.max_len + K + 1
        self._tokens_a_step = K + 1  # the most a step (a round) gives a slot
        self._round = self._params_d = None
        if draft_model is not None:
            self._round = make_spec_round(model.dims, draft_model.dims, self._task.filter_cfg,
                                          self._task.tokenizer.eot, K, self._task.compute_dtype)
            self._params_d = draft_params(self._task, draft_model)  # the draft's decode copy
        self._state: Optional[State] = None

    # -- prefill and state ----------------------------------------------------

    def _prefill(self, reqs: Sequence[Tuple[object, Optional[int]]]) -> State:
        """Prefill (wave or mel, max_tokens) requests together: a k-row state
        with its first token chosen."""
        task, dev = self._task, self.device
        n_mels = self.model.dims.n_mels
        k = len(reqs)
        mels: Dict[int, torch.Tensor] = {
            i: torch.as_tensor(p, dtype=torch.float32).to(dev)
            for i, (p, _) in enumerate(reqs) if np.ndim(p) == 2
        }
        waves = [(i, np.asarray(pad_or_trim(np.asarray(p, np.float32), N_SAMPLES)))
                 for i, (p, _) in enumerate(reqs) if np.ndim(p) == 1]
        if waves:
            wmel = log_mel_spectrogram(np.stack([w for _, w in waves]), n_mels=n_mels, device=dev)
            mels.update({i: wmel[j] for j, (i, _) in enumerate(waves)})
        mel = torch.stack([mels[i] for i in range(k)])
        init = torch.tensor([task.initial_tokens] * k, dtype=torch.long, device=dev)
        caps = [task.max_len if mt is None else min(task.sample_begin + int(mt), task.max_len)
                for _, mt in reqs]
        caps = torch.tensor(caps, dtype=torch.long, device=dev)
        dtype = task.compute_dtype
        logits, cache_v = task.prefill(task.params, _features(self.model, mel, dtype), init,
                                       extra_len=self._k)
        rows: State = {"cache_v": cache_v}
        if self.draft_model is not None:
            rows["cache_d"] = task.prefill(self._params_d, _features(self.draft_model, mel, dtype),
                                           init, extra_len=self._k)[1]
        nsp = task.no_speech_probs(logits)
        rows.update(task.first_tokens(logits, init, self._buf_w, caps), no_speech_probs=nsp)
        return rows

    def _empty_state(self, slots: int) -> State:
        """Idle slots: finished, length 2 (a speculative round reads
        positions n-2 and n-1), caches of silent audio features."""
        task, dev = self._task, self.device

        def cache(params):
            d = params.dims
            feats = torch.zeros((slots, d.n_audio_ctx, d.n_audio_state), device=dev)
            return task.new_cache(params, feats, extra_len=self._k)

        state: State = {
            "tokens": torch.full((slots, self._buf_w), task.tokenizer.eot, dtype=torch.long,
                                 device=dev),
            "lens": torch.full((slots,), 2, dtype=torch.long, device=dev),
            "caps": torch.full((slots,), task.max_len, dtype=torch.long, device=dev),
            "finished": torch.ones((slots,), dtype=torch.bool, device=dev),
            "sum_logprobs": torch.zeros((slots,), device=dev),
            "no_speech_probs": torch.zeros((slots,), device=dev),
            "cache_v": cache(task.params),
        }
        if self.draft_model is not None:
            state["cache_d"] = cache(self._params_d)
        return state

    def _copy_rows(self, dst: State, dst_idx: Sequence[int], src: State,
                   src_idx: Sequence[int]) -> None:
        """Splice rows ``src_idx`` of ``src`` into slots ``dst_idx`` of
        ``dst``, in place; the caches' slot axis is 1."""
        di = torch.tensor(list(dst_idx), dtype=torch.long, device=self.device)
        si = torch.tensor(list(src_idx), dtype=torch.long, device=self.device)
        for key in _ROW_KEYS:
            dst[key].index_copy_(0, di, src[key].index_select(0, si))
        for ck in ("cache_v", "cache_d"):
            if ck in dst:
                for key, slab in dst[ck].items():
                    slab.index_copy_(1, di, src[ck][key].index_select(1, si))

    # -- stepping -------------------------------------------------------------

    def _step(self, s: State) -> None:
        """One greedy token for every slot (a speculative round with a
        draft), in place; finished slots are no-ops."""
        with profiling.span("serve.step"):
            task = self._task
            if self._round is not None:
                self._round(task.params, self._params_d, s)
                return
            tokens, n = s["tokens"], s["lens"]
            active = ~s["finished"]
            last = tokens.gather(1, (n - 1)[:, None])
            logits, s["cache_v"] = decoder_apply(
                task.params, self.model.dims, last, cache=s["cache_v"],
                offset=(n - 1).to(torch.int32), dtype=task.compute_dtype)
            flt = _apply_filters(task.filter_cfg, logits[:, -1].float(), tokens, n)
            nxt = flt.argmax(dim=-1)
            lp = torch.log_softmax(flt, dim=-1).gather(1, nxt[:, None])[:, 0]
            nxt = torch.where(active, nxt, torch.full_like(nxt, task.tokenizer.eot))
            tokens.scatter_(1, n[:, None], nxt[:, None])
            lens = n + active.long()
            s["lens"] = lens
            s["sum_logprobs"] = s["sum_logprobs"] + torch.where(active, lp, torch.zeros_like(lp))
            s["finished"] = s["finished"] | (nxt == task.tokenizer.eot) | (lens >= s["caps"])

    def _advance(self, s: State, iters: int, stop_on_finish: bool) -> None:
        """Up to ``iters`` steps; ends once no slot is live, or (with
        ``stop_on_finish``) once a slot has newly finished, read one step
        late (see the module docstring)."""
        entry = s["finished"].clone()
        ring = _FlagRing(2, self.device)
        for i in range(iters):
            self._step(s)
            profiling.count("serve.slot_steps", self.slots * self._tokens_a_step)
            fin = s["finished"]
            ring.push(i, torch.stack([(~fin).any(), (fin & ~entry).any()]))
            if i > 0:
                alive, newly = ring.read(i - 1)
                if not alive or (stop_on_finish and newly):
                    break

    # -- incremental serving API ----------------------------------------------

    def _ensure_state(self) -> None:
        if self._state is None:
            self._state = self._empty_state(self.slots)
            self._slot_req = [-1] * self.slots  # request id per slot
            self._slot_gen = [-1] * self.slots  # poll count at splice time
            self._queue: list = []
            self._next_id = 0
            self._poll_n = 0
            self._pending_aux = None  # (poll_n, aux) when pipelined
            # request id -> stamp (ns), kept only while a span sink is installed
            self._submitted: Dict[int, int] = {}
            self._admitted: Dict[int, int] = {}

    def submit(self, wave, max_tokens: Optional[int] = None) -> int:
        """Enqueue one request; returns its id. Takes a <= 30 s waveform
        (1-D) or a log-mel segment (n_mels, 3000)."""
        self._ensure_state()
        rid = self._next_id
        self._next_id += 1
        self._queue.append((rid, wave, max_tokens))
        t = profiling.stamp()
        if t is not None:
            self._submitted[rid] = t
        return rid

    @property
    def pending(self) -> int:
        self._ensure_state()
        return len(self._queue) + sum(r >= 0 for r in self._slot_req)

    def _fill_idle_slots(self) -> None:
        idle = [s for s in range(self.slots) if self._slot_req[s] < 0]
        take = min(len(idle), len(self._queue))
        if not take:
            return
        with profiling.span("serve.admit"):
            reqs = [self._queue.pop(0) for _ in range(take)]
            t = profiling.stamp()
            for rid, _, _ in reqs:
                submitted = self._submitted.pop(rid, None)
                if t is not None:
                    if submitted is not None:
                        profiling.record("serve.queued", submitted, t, rid=rid)
                    self._admitted[rid] = t
            rows = self._prefill([(w, mt) for _, w, mt in reqs])
            self._copy_rows(self._state, idle[:take], rows, range(take))
            for j, (rid, _, _) in enumerate(reqs):
                self._slot_req[idle[j]] = rid
                self._slot_gen[idle[j]] = self._poll_n

    def _snapshot(self):
        """The slots' host-visible state (tokens, length, finished; score,
        no-speech probability), copied to the host without blocking."""
        s = self._state
        aux_i = torch.cat([s["tokens"], s["lens"][:, None], s["finished"].long()[:, None]], 1)
        aux_f = torch.stack([s["sum_logprobs"], s["no_speech_probs"]], 1)
        pin = self.device.type == "cuda"
        host = [torch.empty(a.shape, dtype=a.dtype, pin_memory=pin) for a in (aux_i, aux_f)]
        for h, a in zip(host, (aux_i, aux_f)):
            h.copy_(a, non_blocking=True)
        event = None
        if pin:
            event = torch.cuda.Event()
            event.record()
        return host, event

    def _harvest(self, tagged) -> List[tuple]:
        """Finalize every finished slot that ``tagged`` covers: slots spliced
        after the step that produced it describe their previous occupant
        and are skipped."""
        aux_n, ((aux_i, aux_f), event) = tagged
        if event is not None:
            event.synchronize()
        aux_i, aux_f = aux_i.numpy(), aux_f.numpy()
        done = []
        for s in range(self.slots):
            rid = self._slot_req[s]
            if rid < 0 or self._slot_gen[s] > aux_n or not aux_i[s, -1]:
                continue
            res = self._finalize_row(aux_i[s, :-2], aux_f[s, 0], aux_f[s, 1])
            profiling.count("serve.tokens", len(res.tokens))
            done.append((rid, res))
            self._slot_req[s] = -1
        return done

    def _dispatch_step(self):
        queued = bool(self._queue)
        tokens = self.chunk if queued else self.drain_chunk
        if self.draft_model is not None:  # iterations are speculative rounds
            iters = max(1, -(-tokens // (self.draft_len + 1)))
        else:
            iters = tokens
        self._advance(self._state, iters, self.stop_on_finish and queued)
        self._poll_n += 1
        return (self._poll_n - 1, self._snapshot())

    def warmup(self) -> None:
        """Build the kernels and the decode weights before traffic: one
        prefill of silence and one step on a scratch state (the live slots
        are not touched)."""
        self._ensure_state()
        rows = self._prefill([(np.zeros(16000, np.float32), 1)])
        scratch = self._empty_state(self.slots)
        self._copy_rows(scratch, [0], rows, [0])
        self._step(scratch)

    def poll(self) -> List[tuple]:
        """Advance all slots one chunk; returns [(request_id, result)] for
        the requests that finished (possibly none while work is in flight;
        see :attr:`pending`). With ``pipeline`` the harvest lags one chunk:
        poll k runs chunk k and then reads chunk k-1's copied results."""
        with profiling.span("serve.poll"):
            done = self._poll()
        if self._admitted:  # requests admitted while a span sink was installed
            t = profiling.stamp()
            for rid, _ in done:
                admitted = self._admitted.pop(rid, None)
                if admitted is not None and t is not None:
                    profiling.record("serve.in_slot", admitted, t, rid=rid)
        return done

    def _poll(self) -> List[tuple]:
        self._ensure_state()
        self._fill_idle_slots()
        if all(r < 0 for r in self._slot_req):
            if self._pending_aux is not None:  # drain the pipelined tail
                done = self._harvest(self._pending_aux)
                self._pending_aux = None
                return done
            return []
        aux = self._dispatch_step()
        if self.pipeline:
            prev, self._pending_aux = self._pending_aux, aux
            return self._harvest(prev) if prev is not None else []
        done = self._harvest(aux)
        self._fill_idle_slots()
        return done

    def run_queued(self, pool_cap: Optional[int] = None,
                   sort_admission: bool = True) -> List[tuple]:
        """Drain the queue (offline / throughput mode): prefill up to
        ``pool_cap`` queued requests together into a pool on the device,
        then step the slots and splice the next pool row into each slot
        that finishes, with no host round trip but the flags' lagged copy.
        Returns [(request_id, result)]. ``pool_cap`` bounds the pool's
        device memory (every row holds its prefilled caches).
        ``sort_admission`` admits the largest token budgets first (a long
        row admitted last would stretch the tail alone); results do not
        change, only the order of the work. Slots of :meth:`poll` are not
        touched."""
        self._ensure_state()
        done: List[tuple] = []
        while self._queue:
            take = len(self._queue) if pool_cap is None else min(int(pool_cap), len(self._queue))
            reqs = [self._queue.pop(0) for _ in range(take)]
            for rid, _, _ in reqs:
                self._submitted.pop(rid, None)
            if sort_admission:
                full = self._task.max_len  # no budget: the full budget
                reqs.sort(key=lambda r: full if r[2] is None else int(r[2]), reverse=True)
            pool = self._prefill([(w, mt) for _, w, mt in reqs])
            out = self._run_pool(pool, take)
            done.extend((rid, res) for (rid, _, _), res in zip(reqs, out))
        return done

    def _run_pool(self, pool: State, n_req: int) -> List[DecodingResult]:
        S, dev = self.slots, self.device
        state = self._empty_state(S)
        out = {"tokens": torch.empty((n_req, self._buf_w), dtype=torch.long, device=dev),
               "sum_logprobs": torch.empty((n_req,), device=dev),
               "no_speech_probs": torch.empty((n_req,), device=dev)}
        first = min(S, n_req)
        self._copy_rows(state, range(first), pool, range(first))
        slot_row = list(range(first)) + [-1] * (S - first)  # pool row per slot
        spliced_at = [-1] * S  # the step after which the slot was filled
        next_row = first
        ring = _FlagRing(S, dev)
        i = 0
        while True:
            self._step(state)
            ring.push(i, state["finished"])
            if i > 0:
                fin = ring.read(i - 1)
                ended = [s for s in range(S)
                         if slot_row[s] >= 0 and fin[s] and spliced_at[s] < i - 1]
                if ended:
                    idx = torch.tensor(ended, dtype=torch.long, device=dev)
                    rows = torch.tensor([slot_row[s] for s in ended], dtype=torch.long,
                                        device=dev)
                    for key in out:
                        out[key].index_copy_(0, rows, state[key].index_select(0, idx))
                    refill = ended[: n_req - next_row]
                    if refill:
                        self._copy_rows(state, refill, pool,
                                        range(next_row, next_row + len(refill)))
                    for s in ended:
                        slot_row[s], spliced_at[s] = -1, -1
                    for s in refill:
                        slot_row[s], spliced_at[s] = next_row, i
                        next_row += 1
                if next_row == n_req and all(r < 0 for r in slot_row):
                    break
            i += 1
        tokens = out["tokens"].cpu().numpy()
        lps = out["sum_logprobs"].cpu().numpy()
        nsps = out["no_speech_probs"].cpu().numpy()
        return [self._finalize_row(tokens[j], lps[j], nsps[j]) for j in range(n_req)]

    def transcribe_segments(
        self, waveforms: Sequence[np.ndarray], max_tokens: Optional[Sequence[int]] = None,
        pooled: bool = False, pool_cap: Optional[int] = None,
    ) -> List[DecodingResult]:
        """Decode <= 30 s waveforms with continuous slot refill; results in
        input order. ``max_tokens`` caps each request's generated tokens;
        ``pooled`` goes through :meth:`run_queued`."""
        if not len(waveforms):
            return []
        ids = [self.submit(w, max_tokens[i] if max_tokens else None)
               for i, w in enumerate(waveforms)]
        if pooled:
            by_id = dict(self.run_queued(pool_cap=pool_cap))
        else:
            by_id = {}
            while self.pending:
                by_id.update(self.poll())
        return [by_id[rid] for rid in ids]

    def _finalize_row(self, tokens: np.ndarray, sum_logprob: float,
                      no_speech_prob: float) -> DecodingResult:
        tokenizer = self._task.tokenizer
        t = np.asarray(tokens)
        sb = self._task.sample_begin
        eots = np.nonzero(t[sb:] == tokenizer.eot)[0]
        end = sb + (eots[0] if len(eots) else len(t))
        toks = t[sb:end].tolist()
        text = tokenizer.decode(toks).strip()
        return DecodingResult(
            audio_features=None, language=self.options.language, tokens=toks, text=text,
            avg_logprob=float(sum_logprob) / (len(toks) + 1),
            no_speech_prob=float(no_speech_prob), temperature=0.0,
            compression_ratio=compression_ratio(text),
        )
