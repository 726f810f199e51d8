"""Conversion CLI: ``python -m whisperx_tpu_torch.convert <family> --src --out``.

Counterpart of ``whisperx_tpu/convert/__main__.py``, with its subcommands,
flags, defaults and printed lines: it writes the same checkpoint
directories, which both packages read. ``whisper --quantize`` loads the
converted checkpoint on the host: quantization is host work (numpy), so the
card would only hold the model in between.
"""

import argparse
import os


def main():
    parser = argparse.ArgumentParser(prog="whisperx_tpu_torch.convert")
    sub = parser.add_subparsers(dest="family", required=True)

    w = sub.add_parser("whisper", help="HF or OpenAI Whisper checkpoint")
    w.add_argument("--src", required=True, help="HF model dir or OpenAI .pt file")
    w.add_argument("--out", required=True)
    w.add_argument("--name", default=None)
    w.add_argument("--quantize", choices=["int8", "int4"], default=None,
                   help="also emit a quantized copy at <out>-<mode>")

    a = sub.add_parser("wav2vec2", help="HF Wav2Vec2ForCTC dir or torchaudio bundle")
    a.add_argument("--src", required=True)
    a.add_argument("--out", required=True)
    a.add_argument("--torchaudio", action="store_true",
                   help="treat --src as a torchaudio bundle name")

    v = sub.add_parser("silero", help="Silero VAD (ONNX file or torch.hub)")
    v.add_argument("--src", default=None, help="path to silero_vad.onnx")
    v.add_argument("--out", required=True)

    p = sub.add_parser("pyannote", help="pyannote segmentation checkpoint (PyanNet)")
    p.add_argument("--src", required=True, help="dir or pytorch_model.bin")
    p.add_argument("--out", required=True)

    s = sub.add_parser("wespeaker", help="wespeaker ResNet speaker-embedding checkpoint")
    s.add_argument("--src", required=True)
    s.add_argument("--out", required=True)

    args = parser.parse_args()

    if args.family == "whisper":
        if args.src.endswith(".pt"):
            from whisperx_tpu_torch.convert.whisper_hf import convert_openai_whisper

            convert_openai_whisper(args.src, args.out, args.name)
        else:
            from whisperx_tpu_torch.convert.whisper_hf import convert_hf_whisper

            convert_hf_whisper(args.src, args.out, args.name)
        if args.quantize:
            import shutil

            from whisperx_tpu_torch.convert.checkpoint import save_checkpoint
            from whisperx_tpu_torch.models.whisper import load_model
            from whisperx_tpu_torch.quant import quantize_model

            model = load_model(args.out, device="cpu")  # bf16, as JAX's default
            qm = quantize_model(model, mode=args.quantize)
            qout = f"{args.out}-{args.quantize}"
            save_checkpoint(
                qout,
                qm,
                {
                    "family": "whisper",
                    "name": f"{qm.name}",
                    "dims": model.dims.__dict__,
                    "alignment_heads": model.alignment_heads,
                },
            )
            vocab = os.path.join(args.out, "vocab.tiktoken")
            if os.path.exists(vocab):
                shutil.copy(vocab, os.path.join(qout, "vocab.tiktoken"))
            print(f"quantized ({args.quantize}) → {qout}")
        print(f"converted whisper → {args.out}")
    elif args.family == "wav2vec2":
        if args.torchaudio:
            from whisperx_tpu_torch.convert.wav2vec2_hf import convert_torchaudio_wav2vec2

            convert_torchaudio_wav2vec2(args.src, args.out)
        else:
            from whisperx_tpu_torch.convert.wav2vec2_hf import convert_hf_wav2vec2

            convert_hf_wav2vec2(args.src, args.out)
        print(f"converted wav2vec2 → {args.out}")
    elif args.family == "silero":
        if args.src:
            from whisperx_tpu_torch.convert.silero import convert_silero_onnx

            convert_silero_onnx(args.src, args.out)
        else:
            from whisperx_tpu_torch.convert.silero import convert_silero_torch

            convert_silero_torch(args.out)
        print(f"converted silero VAD → {args.out}")
    elif args.family == "pyannote":
        from whisperx_tpu_torch.convert.pyannote import convert_pyannote_segmentation

        convert_pyannote_segmentation(args.src, args.out)
        print(f"converted pyannote segmentation → {args.out}")
    elif args.family == "wespeaker":
        from whisperx_tpu_torch.convert.wespeaker import convert_wespeaker_resnet

        convert_wespeaker_resnet(args.src, args.out)
        print(f"converted wespeaker embedding → {args.out}")


if __name__ == "__main__":
    main()
