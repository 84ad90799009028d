"""Datasets and sample construction (own copies of the JAX package's
``data/``): MatchTime, Ego4D narrations, VideoLLaVA-style SFT, and the
offline CLIP feature extraction that training can read instead of video."""
from .preprocess import (
    build_score_conversation,
    build_score_sample,
    preprocess_llama2_score,
)
from .matchtime import (
    MatchTimeDataset,
    MatchTimeIndex,
    build_index,
    collate_score_batch,
    extract_video_half,
    find_half_videos,
    insert_silence_samples,
    parse_labels_caption,
    trans_video_to_json,
)
from .ego4d import (
    Ego4dNarrationDataset,
    ceil_time_by_fps,
    collate_ego4d_batch,
    ego_video_name_2_video_path,
    find_mp4_files,
    get_annos,
    preprocess_llama_2_ego4d,
)
