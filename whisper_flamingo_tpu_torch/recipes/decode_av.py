"""Audio-visual decode CLI: the port of the JAX package's
``recipes/decode_av.py`` (the upstream ``whisper_decode_video.py``
contract):

    python -m whisper_flamingo_tpu_torch.recipes.decode_av --lang en \
        --model-type large-v2 --modalities avsr --checkpoint-path ckpt.pt \
        --av-hubert-ckpt avhubert.pt --beam-size 15 --noise-snr 1000 \
        --manifest data/test.tsv [--device cpu]

Modalities: ``asr`` (audio only, ``test_a``), ``vsr`` (video only,
``test_v``), ``avsr`` (both; an ``*-avsr`` trunk also reads the stacked
fbank of the audio). The manifest is a TSV of id, wav path, text and
video path (a .npy of (T, H, W) lip crops). Every batch decodes through
the one ``DecodingTask`` the ``AVWhisper`` holds for the options, its video
padded to the batch's longest clip. Writes ``hypo.txt`` and
``ref.txt`` under ``--decode-dir`` and prints WER and CER. It runs on the
card unless ``--device`` names another; with no card and no device named
it raises. :func:`main` returns the printed metrics.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

import whisper_flamingo_tpu_torch as wt

from ..audio import load_audio, pad_or_trim
from ..data.dataset import ManifestAsrSource
from ..data.noise import add_noise
from ..metrics import wer_cer
from ..models.avhubert import (
    VIDEO_ENCODER_CONFIGS,
    AVWhisper,
    init_video_encoder,
    load_avhubert_torch,
    stacked_fbank_features,
)
from ..normalizers import BasicTextNormalizer
from ..training.checkpoints import torch_load_prefer_safe
from ..utils import resolve_device


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--lang", default="en")
    parser.add_argument("--model-type", default="large-v2")
    parser.add_argument("--modalities", default="avsr", choices=["asr", "vsr", "avsr"])
    parser.add_argument("--use_av_hubert_encoder", type=int, default=1)
    parser.add_argument("--av_fusion", default="separate", choices=["separate"])
    parser.add_argument("--checkpoint-path", default="")
    parser.add_argument("--av-hubert-ckpt", default="")
    parser.add_argument("--beam-size", type=int, default=1)
    parser.add_argument("--noise-snr", type=int, default=1000)
    parser.add_argument("--noise-wav", default="",
                        help="babble wav mixed at --noise-snr when snr < 1000")
    parser.add_argument("--manifest", required=True,
                        help="TSV: id, wav_path, text [, video_path]")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--decode-dir", default="decode_out")
    parser.add_argument("--video-encoder", default="", choices=["", *VIDEO_ENCODER_CONFIGS],
                        help="override the AV-HuBERT size (default: by model-type)")
    parser.add_argument("--device", default=None, help="default: the card")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    # avsr wants the audio-trunk variant; asr / vsr the video-only one
    default_vcfg = ("large" if "large" in args.model_type else "base") + (
        "-avsr" if args.modalities == "avsr" else ""
    )
    vcfg = VIDEO_ENCODER_CONFIGS[args.video_encoder or default_vcfg]
    model = wt.load_model(args.checkpoint_path or args.model_type, device=device,
                          add_gated_x_attn=1, num_langs=1, bert_dim=vcfg.embed_dim)
    if args.av_hubert_ckpt:
        state = torch_load_prefer_safe(args.av_hubert_ckpt)
        video = load_avhubert_torch(state.get("model", state), vcfg, device=device)
    else:
        video = init_video_encoder(torch.Generator(device=device).manual_seed(0), vcfg,
                                   device=device)
    av = AVWhisper(whisper=model, video=video)

    source = ManifestAsrSource(args.manifest, load_video=args.modalities != "asr")
    normalizer = BasicTextNormalizer(remove_diacritics=True)

    # the noisy eval (the 0 dB babble protocol) needs its noise file
    noise_wavs = None
    if args.noise_snr < 1000:
        if not args.noise_wav:
            raise SystemExit("--noise-snr < 1000 requires --noise-wav")
        noise_wavs = [load_audio(args.noise_wav)]
        noise_rng = np.random.default_rng(0)
    options = wt.DecodingOptions(
        language=args.lang, beam_size=args.beam_size if args.beam_size > 1 else None,
        without_timestamps=True,
    )

    os.makedirs(args.decode_dir, exist_ok=True)
    hyps, refs = [], []
    for start in range(0, len(source), args.batch_size):
        batch = [source[i] for i in range(start, min(start + args.batch_size, len(source)))]
        if noise_wavs is not None:
            for ex in batch:
                ex.audio = add_noise(
                    ex.audio * 32768.0, noise_wavs, args.noise_snr, noise_rng
                ).astype(np.float32) / 32768.0
        mels = torch.stack([
            wt.log_mel_spectrogram(pad_or_trim(ex.audio), n_mels=model.dims.n_mels, device=device)
            for ex in batch
        ])
        video_in = lengths = None
        if args.modalities != "asr":
            vids = [ex.video for ex in batch]  # loaded once by the source
            lengths = [v.shape[0] for v in vids]
            max_t = max(lengths)
            video_in = np.zeros((len(vids), max_t, *vids[0].shape[1:]), np.float32)
            for i, v in enumerate(vids):
                video_in[i, : v.shape[0]] = v
        fbanks = None
        if args.modalities == "avsr" and vcfg.audio_feat_dim is not None:
            # the (noise-mixed) audio as stacked log filterbanks at the video rate
            fbs = [stacked_fbank_features(ex.audio) for ex in batch]
            fbanks = np.zeros((len(fbs), video_in.shape[1], fbs[0].shape[1]), np.float32)
            for i, fb in enumerate(fbs):
                t = min(len(fb), video_in.shape[1])
                fbanks[i, :t] = fb[:t]
        results = av.decode(
            mels, options, video=video_in, audio=fbanks,
            test_a=args.modalities == "asr", test_v=args.modalities == "vsr",
            video_lengths=lengths,
        )
        for ex, r in zip(batch, results):
            hyps.append(normalizer(r.text))
            refs.append(normalizer(ex.text))

    with open(os.path.join(args.decode_dir, "hypo.txt"), "w") as f:
        f.write("\n".join(hyps))
    with open(os.path.join(args.decode_dir, "ref.txt"), "w") as f:
        f.write("\n".join(refs))
    wer, cer = wer_cer(hyps, refs)
    out = {"modalities": args.modalities, "snr": args.noise_snr,
           "wer": round(wer, 4), "cer": round(cer, 4), "n": len(hyps)}
    print(out)
    return out


if __name__ == "__main__":
    main()
