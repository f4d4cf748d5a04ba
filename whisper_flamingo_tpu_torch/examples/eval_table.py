"""The notebook's eval table (the reference's
``notebooks/whisper_flamingo_demo.ipynb`` cells 13-31), a port of the JAX
package's ``examples/eval_table.py``: batched decode of an audio-only
Whisper and an audio-visual Whisper-Flamingo for En ASR (fairseq-13a WER)
and En-X ST (sacreBLEU), clean and in babble.

With no checkpoints (nothing is downloaded) the models take random
weights and the numbers are meaningless: what runs is the protocol, the
same data path, noise mixing (``data.noise.add_noise``), decode options,
normalizers and scoring. ``--checkpoint`` / ``--flamingo-checkpoint`` /
``--video-model-ckpt`` name the released ``whisper_en-x_small.pt`` /
``whisper-flamingo_en-x_small.pt`` / ``large_noise_pt_noise_ft_433h.pt``
and ``--manifest`` a MuAViC test TSV for the published table (beam 15:
``--beam-size 15``). The card is the default device; ``--platform cpu``
(the JAX script's flag) asks for the CPU, so JAX's CI line runs as is:

    python -m whisper_flamingo_tpu_torch.examples.eval_table --platform cpu \\
        --model-type debug --synthetic 4

Without sacrebleu (the card's machine has none) the ST rows score WER,
as the JAX script does.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .demo import device_of

# Synthetic references: En ASR transcripts and their Ru translations (the
# ST task scores hypotheses against the Russian references).
SYNTH_TEXT = {
    "en": [
        "the quick brown fox jumps over the lazy dog",
        "speech recognition systems transcribe spoken language",
        "the weather was clear and the road was empty",
        "she read the report twice before the meeting",
        "a small boat crossed the river at dawn",
        "the museum opens at nine in the morning",
        "he carried two heavy bags up the stairs",
        "music played softly in the next room",
    ],
    "ru": [
        "быстрая коричневая лиса перепрыгивает через ленивую собаку",
        "системы распознавания речи транскрибируют устную речь",
        "погода была ясной и дорога была пустой",
        "она дважды прочитала отчет перед совещанием",
        "маленькая лодка пересекла реку на рассвете",
        "музей открывается в девять утра",
        "он нес две тяжелые сумки вверх по лестнице",
        "в соседней комнате тихо играла музыка",
    ],
}

Row = Tuple[str, str, Dict[int, Tuple[str, float]]]  # (system, task, {snr: (metric, value)})


def synthetic_examples(n: int, seed: int = 3407):
    """n seeded (audio, {lang: ref}) pairs; the audio is band-limited noise."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        dur = 16000 * int(rng.integers(2, 4))
        wave = (rng.standard_normal(dur) * 0.05).astype(np.float32)
        out.append((wave, {lang: SYNTH_TEXT[lang][i % len(SYNTH_TEXT[lang])]
                           for lang in SYNTH_TEXT}))
    return out


def manifest_examples(path: str, lang: str):
    """MuAViC-style TSV: id, wav_path [, video_path], text."""
    from ..data.dataset import ManifestAsrSource

    src = ManifestAsrSource(path, load_video=False)
    return [(src[i].audio, {lang: src[i].text}) for i in range(len(src))]


def score(hyps: List[str], refs: List[str], lang: str) -> Tuple[str, float]:
    """En -> fairseq-13a WER, otherwise corpus BLEU (WER without sacrebleu)."""
    if lang == "en":
        from ..metrics import fairseq_wer

        return "WER%", 100.0 * fairseq_wer(hyps, refs)
    try:
        import sacrebleu

        return "BLEU", sacrebleu.corpus_bleu(hyps, [refs]).score
    except ImportError:
        from ..metrics import wer_cer

        return "WER%(no-sacrebleu)", 100.0 * wer_cer(hyps, refs)[0]


def main(argv: Optional[List[str]] = None) -> List[Row]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-type", default="small")
    parser.add_argument("--checkpoint", default="",
                        help="audio-only system weights (whisper_en-x_small.pt)")
    parser.add_argument("--flamingo-checkpoint", default="",
                        help="AV system weights (whisper-flamingo_en-x_small.pt)")
    parser.add_argument("--video-model-ckpt", default="",
                        help="AV-HuBERT weights (large_noise_pt_noise_ft_433h.pt)")
    parser.add_argument("--manifest", default="",
                        help="test TSV; default: synthetic utterances")
    parser.add_argument("--synthetic", type=int, default=4,
                        help="synthetic utterance count when no --manifest")
    parser.add_argument("--langs", default="en,ru")
    parser.add_argument("--snrs", default="1000,0",
                        help="1000 = clean (reference noise_snr convention)")
    parser.add_argument("--noise-wav", default="",
                        help="babble wav; synthetic babble if omitted")
    parser.add_argument("--beam-size", type=int, default=1)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--platform", default=None, help="cpu for a run on the CPU")
    parser.add_argument("--sample-len", type=int, default=None,
                        help="cap decode length (CI synthetic runs)")
    args = parser.parse_args(argv)
    device = device_of(args.platform)

    import whisper_flamingo_tpu_torch as whisper
    from ..audio import pad_or_trim
    from ..data.noise import add_noise
    from ..models import avhubert
    from ..normalizers import BasicTextNormalizer, EnglishTextNormalizer

    langs = args.langs.split(",")
    snrs = [int(s) for s in args.snrs.split(",")]
    debug = args.model_type == "debug"
    sample_len = args.sample_len if args.sample_len else (16 if debug else None)

    # ---- systems (notebook cells 15 and 26) -----------------------------
    audio_model = whisper.load_model(args.checkpoint or args.model_type, device=device)
    vcfg_name = ("debug-av" if debug
                 else ("large" if "large" in args.model_type else "base") + "-avsr")
    vcfg = avhubert.VIDEO_ENCODER_CONFIGS[vcfg_name]
    flamingo = whisper.load_model(
        args.flamingo_checkpoint or args.model_type, device=device,
        add_gated_x_attn=1, num_langs=1, bert_dim=vcfg.embed_dim,
    )
    if args.video_model_ckpt:
        from ..training.checkpoints import torch_load_prefer_safe

        state = torch_load_prefer_safe(args.video_model_ckpt)
        video = avhubert.load_avhubert_torch(state.get("model", state), vcfg, device=device)
    else:
        video = avhubert.init_video_encoder(torch.Generator(device=device).manual_seed(0), vcfg,
                                            device=device)
    av = avhubert.AVWhisper(whisper=flamingo, video=video)

    # ---- noise (notebook cell 11: one babble wav mixed at --snr) --------
    if args.noise_wav:
        noise = [whisper.load_audio(args.noise_wav)]
    else:  # synthetic babble: a sum of shifted copies
        rng = np.random.default_rng(1)
        noise = [np.sum([np.roll(rng.standard_normal(16000 * 4), s)
                         for s in (0, 1777, 6151)], axis=0).astype(np.float32) * 0.05]

    en_norm = EnglishTextNormalizer()
    basic_norm = BasicTextNormalizer(remove_diacritics=True)

    def decode_system(name, lang, snr):
        examples = (manifest_examples(args.manifest, lang) if args.manifest
                    else synthetic_examples(args.synthetic))
        options = whisper.DecodingOptions(
            language=lang, without_timestamps=True,
            beam_size=args.beam_size if args.beam_size > 1 else None,
            task="transcribe" if lang == "en" else "translate",
            sample_len=sample_len, fp16=not debug,
        )
        norm = en_norm if lang == "en" else basic_norm
        noise_rng = np.random.default_rng(0)
        hyps, refs = [], []
        for start in range(0, len(examples), args.batch_size):
            chunk = examples[start:start + args.batch_size]
            waves = []
            for wave, _ in chunk:
                if snr < 1000:
                    wave = add_noise(wave * 32768.0, noise, snr,
                                     noise_rng).astype(np.float32) / 32768.0
                waves.append(wave)
            mels = torch.stack([
                whisper.log_mel_spectrogram(pad_or_trim(w), n_mels=audio_model.dims.n_mels,
                                            device=device)
                for w in waves
            ])
            if name == "audio":
                results = whisper.decode(audio_model, mels, options)
            else:  # avsr: synthetic video + the real stacked-fbank audio trunk
                vrng = np.random.default_rng(start)
                t = 24 if debug else 64
                hw = 48 if debug else 88
                video_in = vrng.standard_normal((len(chunk), t, hw, hw)).astype(np.float32)
                fbanks = None
                if vcfg.audio_feat_dim is not None:
                    # the real trunks take 104 dims; the debug trunk is
                    # narrower, so the feature axis is cropped to fit
                    fbs = [avhubert.stacked_fbank_features(w) for w in waves]
                    fbanks = np.zeros((len(fbs), t, vcfg.audio_feat_dim), np.float32)
                    for i, fb in enumerate(fbs):
                        tt = min(len(fb), t)
                        fbanks[i, :tt] = fb[:tt, :vcfg.audio_feat_dim]
                results = av.decode(mels, options, video=video_in, audio=fbanks)
            for (_, ref_by_lang), r in zip(chunk, results):
                hyps.append(norm(r.text))
                refs.append(norm(ref_by_lang[lang]))
        return score(hyps, refs, lang)

    rows: List[Row] = []
    for sys_name, label in (("audio", f"Whisper {args.model_type} (audio)"),
                            ("avsr", f"Whisper-Flamingo {args.model_type} (AV)")):
        for lang in langs:
            task = "En ASR" if lang == "en" else f"En-{lang.title()} ST"
            rows.append((label, task, {snr: decode_system(sys_name, lang, snr) for snr in snrs}))

    col = {1000: "clean"}
    headers = ["System", "Task", "Metric"] + [col.get(s, f"{s} dB babble") for s in snrs]
    widths = [max(len(h), 34) for h in headers[:1]] + [12] * (len(headers) - 1)
    print("| " + " | ".join(h.ljust(w) for h, w in zip(headers, widths)) + " |")
    print("|" + "|".join("-" * (w + 2) for w in widths) + "|")
    for label, task, vals in rows:
        metric = next(iter(vals.values()))[0]
        cells = [label, task, metric] + [f"{vals[s][1]:.2f}" for s in snrs]
        print("| " + " | ".join(c.ljust(w) for c, w in zip(cells, widths)) + " |")
    if not (args.checkpoint and args.flamingo_checkpoint):
        print("\n(random-init weights — numbers are plumbing-only; pass "
              "--checkpoint/--flamingo-checkpoint/--video-model-ckpt for "
              "the published table)")
    return rows


if __name__ == "__main__":
    main()
