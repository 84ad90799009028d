"""Interactive CLI chat: load a model, read user turns, print the replies.

    python -m streammind_torch.serve.cli --model-path ckpt/ --video-file clip.mp4

The checkpoint must hold a tokenizer that ``transformers`` can load.
"""
from __future__ import annotations

import argparse
import sys


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", type=str, required=True)
    parser.add_argument("--video-file", type=str, default=None)
    parser.add_argument("--image-file", type=str, default=None)
    parser.add_argument("--temperature", type=float, default=0.2)
    parser.add_argument("--max-new-tokens", type=int, default=512)
    parser.add_argument("--num-frames", type=int, default=8)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args()

    from .. import api
    from ..conversation import conv_templates
    from ..mm_utils import process_image, process_video

    model, processor, tokenizer, version = api.model_init(args.model_path, device=args.device)
    if tokenizer is None:
        print(f"error: no tokenizer could be loaded from {args.model_path}", file=sys.stderr)
        sys.exit(1)
    conv = conv_templates["mistral_instruct"].copy()

    if args.video_file:
        video = process_video(args.video_file, num_frames=args.num_frames)
    elif args.image_file:
        video = process_image(args.image_file)
    else:
        print("error: provide --video-file or --image-file", file=sys.stderr)
        sys.exit(1)

    # api.infer attaches the modal token itself; the CLI carries the
    # dialogue history so every turn sees the whole conversation
    history = []
    while True:
        try:
            inp = input(f"{conv.roles[0]}: ")
        except EOFError:
            break
        if not inp:
            break
        print(f"{conv.roles[1]}: ", end="", flush=True)
        out = api.infer(
            model, video, inp, tokenizer,
            do_sample=args.temperature > 0,
            temperature=args.temperature if args.temperature > 0 else None,
            max_new_tokens=args.max_new_tokens,
            version=version,
            history=history,
        )
        history.append((inp, out))
        print(out)


if __name__ == "__main__":
    main()
