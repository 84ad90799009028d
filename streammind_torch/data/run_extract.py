"""Feature pre-extraction CLI — the reference's encode_video_ori.py run as a
rank-sliced sweep over the MatchTime tree (the JAX package's
``data/run_extract.py``): the CLIP ViT in bf16 on ``--device`` over fixed
batches of ``--batch`` frames (the last one padded), fp16 ``.npz`` shards.

  python -m streammind_torch.data.run_extract \
      --vision-path clip-ckpt/ --data-path MatchTime/features_video \
      [--num-chunks N --chunk-idx K] [--device cpu]
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def make_encode_fn(vision_params, cfg, batch: int = 64, device="cuda"):
    """(T, 3, H, W) fp32 pixels → (T, P, D) fp16 features: the ViT
    (``vision_params`` as they are, default attention; pixels cast to their
    dtype) under no_grad over fixed batches of ``batch`` frames, the last
    padded with zero frames."""
    from ..models.vit import vit_forward
    from ..streaming.engine import _float_dtype

    dtype = _float_dtype(vision_params)

    @torch.no_grad()
    def encode_fn(pixels: np.ndarray) -> np.ndarray:
        outs = []
        for i in range(0, len(pixels), batch):
            blk = pixels[i : i + batch]
            n = len(blk)
            if n < batch:
                blk = np.concatenate([blk, np.zeros_like(blk[:1].repeat(batch - n, 0))])
            x = torch.from_numpy(np.ascontiguousarray(blk, np.float32)).to(device)
            feats = vit_forward(vision_params, cfg, x.to(dtype))
            outs.append(feats[:n].to(torch.float16).cpu().numpy())
        return np.concatenate(outs)

    return encode_fn


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--vision-path", required=True,
                        help="CLIP checkpoint dir (HF naming) or 'random' for smoke runs")
    parser.add_argument("--data-path", required=True)
    parser.add_argument("--chunk-frames", type=int, default=500)
    parser.add_argument("--num-chunks", type=int, default=1)
    parser.add_argument("--chunk-idx", type=int, default=0)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--out-tag", default="features_video_encode")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from ..config import VisionConfig
    from ..eval.mcqa import get_chunk
    from ..models.vit import init_vit_params
    from ..utils.params import cast_tree, tree_map
    from .extract import extract_video_features
    from .matchtime import extract_video_half, find_half_videos

    cfg = VisionConfig()
    if args.vision_path == "random":
        g = torch.Generator(device=args.device).manual_seed(0)
        params = init_vit_params(g, cfg, device=args.device, dtype=torch.float32)
    else:
        from ..utils.convert import convert_clip_vision, load_state_dict

        params = convert_clip_vision(load_state_dict(args.vision_path), cfg)
    params = tree_map(lambda t: t.to(args.device), cast_tree(params, torch.bfloat16))
    encode_fn = make_encode_fn(params, cfg, args.batch, args.device)

    videos = get_chunk(find_half_videos(args.data_path), args.num_chunks, args.chunk_idx)
    total = 0
    for path in videos:
        shards = extract_video_features(
            path, encode_fn, extract_video_half(path), chunk=args.chunk_frames,
            out_tag=args.out_tag,
        )
        total += len(shards)
        print(f"[extract] {path}: {len(shards)} shards")
    print(json.dumps({"videos": len(videos), "shards": total}))


if __name__ == "__main__":
    main()
