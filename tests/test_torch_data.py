"""The port's datasets and feature extraction (``streammind_torch/data``)
against the JAX package's.

The cases of ``tests/test_data.py`` and ``tests/test_extract_sft.py`` run on
both packages with the same inputs (the sentencepiece-like fake tokenizer,
synthetic MatchTime / Ego4D / SFT trees in tmp_path, seeded RNGs): samples,
labels and masks must be equal.  Shards extracted through a tiny fp32 ViT
(the port's ``run_extract.make_encode_fn`` against the JAX ``vit_forward``
on one carried-over tree) agree within one fp16 step; ``train()`` builds its
dataset from ``--dataset`` as the JAX package does.
"""
import json
import os
import random

import jax
import numpy as np
import pytest

from sp_like_tokenizer import SPLikeTokenizer
from streammind_torch import config as tconfig
from streammind_torch import data as tdata
from streammind_torch import native as tnative
from streammind_torch.data import ego4d as tego
from streammind_torch.data import extract as textract
from streammind_torch.data import run_extract as trun_extract
from streammind_torch.data import sft as tsft
from streammind_torch.train import args as targs
from streammind_torch.train import run as trun
from streammind_torch.utils.from_jax import params_from_numpy
from streammind_tpu import data as jdata
from streammind_tpu import native as jnative
from streammind_tpu.config import tiny_streammind_config
from streammind_tpu.data import ego4d as jego
from streammind_tpu.data import extract as jextract
from streammind_tpu.data import sft as jsft
from streammind_tpu.models.vit import init_vit_params, vit_forward


def _equal(a, b, path="sample"):
    """Recursive equality of two samples (arrays bitwise, dtypes equal)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.fixture
def tok():
    return SPLikeTokenizer()


@pytest.fixture(scope="module")
def ingest(tmp_path_factory):
    """The native library (built by the port) behind both packages."""
    if not tnative.available():
        pytest.skip("the ingest library does not build here")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_NATIVE_DIR", str(tmp_path_factory.mktemp("no_src")))
        mp.setattr(jnative, "_LIB_PATH", str(tnative.lib_path()))
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "_load_failed", False)
        assert jnative.available()
        yield


# ---------------------------------------------------------------------------
# preprocessing and MatchTime (tests/test_data.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("caption", ["A great goal is scored!", "</s>", "kick off  now "])
def test_score_sample_labels_match_jax(tok, caption):
    a = jdata.preprocess_llama2_score(caption, tok)
    b = tdata.preprocess_llama2_score(caption, tok)
    _equal(b, a)
    assert (b["labels"][0] != -100).sum() > 0
    _equal(tdata.build_score_sample(caption, "x/1_224p.mkv", 1, 30, tok, past_review_caption="p"),
           jdata.build_score_sample(caption, "x/1_224p.mkv", 1, 30, tok, past_review_caption="p"))


@pytest.mark.parametrize("ts", [[10, 11, 100], [100, 250], [0, 5], [0, 1], [3, 40, 41, 200]])
def test_insert_silence_samples_match_jax(ts):
    caps = [f"c{i}" for i in range(len(ts))]
    for seed in range(20):
        a = jdata.insert_silence_samples(ts, caps, random.Random(seed))
        b = tdata.insert_silence_samples(ts, caps, random.Random(seed))
        assert b == a


def test_matchtime_paths_match_jax():
    for p in ("/data/MatchTime/features_video/epl/2015-x/1_224p.mkv",
              "/d/features_video/a/2_224p.mkv", "/d/other/clip.mp4"):
        assert tdata.trans_video_to_json(p) == jdata.trans_video_to_json(p)
        assert tdata.extract_video_half(p) == jdata.extract_video_half(p)


def _make_matchtime_tree(tmp_path, n_matches=2):
    for m in range(n_matches):
        feat = tmp_path / "features_video" / "epl" / f"match{m}"
        feat.mkdir(parents=True)
        lab = tmp_path / "dataset" / "MatchTime" / "train" / "epl" / f"match{m}"
        lab.mkdir(parents=True)
        for half in (1, 2):
            (feat / f"{half}_224p.mkv").write_bytes(b"")
        anns = {"annotations": [
            {"gameTime": "1 - 10:00", "anonymized": f"late goal {m}"},
            {"gameTime": "1 - 01:00", "anonymized": "kick off"},
            {"gameTime": "1 - 01:01", "anonymized": "a quick pass"},
            {"gameTime": "2 - 05:00", "anonymized": "second half event"},
            {"gameTime": "2 - 07:30", "anonymized": "a corner"},
            {"gameTime": "bogus"},
        ]}
        (lab / "Labels-caption.json").write_text(json.dumps(anns))
    return str(tmp_path / "features_video")


def _fake_loader(video_path, start_ts, end_ts):
    n = max(int((end_ts - start_ts) * 2), 1)
    seed = abs(hash((os.path.basename(video_path), start_ts, end_ts))) % (2 ** 31)
    return np.random.default_rng(seed).standard_normal((n, 3, 8, 8)).astype(np.float32)


def test_matchtime_index_and_dataset_match_jax(tmp_path, tok):
    root = _make_matchtime_tree(tmp_path)
    video = os.path.join(root, "epl", "match0", "1_224p.mkv")
    for half in (1, 2):
        assert (tdata.parse_labels_caption(tdata.trans_video_to_json(video), half)
                == jdata.parse_labels_caption(jdata.trans_video_to_json(video), half))
    for seed in (0, 3):
        a, b = jdata.build_index(root, seed=seed), tdata.build_index(root, seed=seed)
        assert vars(b) == vars(a) and len(b) == len(a) > 8
        assert [b.locate(i) for i in range(len(b))] == [a.locate(i) for i in range(len(a))]
    jds = jdata.MatchTimeDataset(root, tok, frame_loader=_fake_loader, seed=1)
    tds = tdata.MatchTimeDataset(root, tok, frame_loader=_fake_loader, seed=1)
    assert len(tds) == len(jds)
    for i in range(len(tds)):  # early captions retry at seeded random indices
        a, b = jds[i], tds[i]
        _equal(b, a)
        _equal(tdata.collate_score_batch([b]), jdata.collate_score_batch([a]))
    with pytest.raises(ValueError, match="batch_size 1"):
        tdata.collate_score_batch([b, b])


# ---------------------------------------------------------------------------
# Ego4D
# ---------------------------------------------------------------------------
NARRATIONS = [(0.5, "You open the door."), (2.0, "You enter the room."), (2.5, "You sit down.")]


@pytest.mark.parametrize("max_turns", [None, 2])
def test_ego4d_multiturn_matches_jax(tok, max_turns):
    a = jdata.preprocess_llama_2_ego4d(NARRATIONS, tok, fps=2, max_turns=max_turns)
    b = tdata.preprocess_llama_2_ego4d(NARRATIONS, tok, fps=2, max_turns=max_turns)
    _equal(b, a)
    assert (b["input_ids"][0] == -201).sum() == len(b["span_frames"])


def test_ego4d_annotations_and_dataset_match_jax(tok, tmp_path):
    official = {"uid_a": {"narration_pass_1": {"narrations": [
        {"narration_text": "#C C opens the door", "timestamp_sec": 0.4},
        {"narration_text": "#C C picks a cup", "timestamp_sec": 1.1},
        {"narration_text": "#C C drops it", "timestamp_sec": 1.2},  # same 0.5 s slot
        {"narration_text": "#C C walks", "timestamp_sec": 4.9}]}},
        "uid_b": [[0.3, "You look around."], [2.2, "You sit."], [3.0, ""]],
        "uid_empty": []}
    path = tmp_path / "annos.json"
    path.write_text(json.dumps(official))
    for fps in (2, 4):
        assert tdata.get_annos(str(path), fps) == jdata.get_annos(str(path), fps)
    vids = tmp_path / "videos"
    vids.mkdir()
    (vids / "x.mp4").write_bytes(b"")
    (vids / "sub").mkdir()
    (vids / "sub" / "y.mp4").write_bytes(b"")
    assert tdata.find_mp4_files(str(vids)) == jdata.find_mp4_files(str(vids))
    for t in (0.0, 0.2, 0.51, 3.99):
        assert tdata.ceil_time_by_fps(t) == jdata.ceil_time_by_fps(t)
    for model_type in ("llm", "cls"):
        kw = dict(model_type=model_type, max_turns=3,
                  frame_loader=lambda p, s, e: np.full((int(e * 2), 3, 8, 8), s, np.float32))
        jds = jego.Ego4dNarrationDataset(str(vids), str(path), tok, **kw)
        tds = tego.Ego4dNarrationDataset(str(vids), str(path), tok, **kw)
        assert tds.uids == jds.uids == ["uid_a", "uid_b"]
        for i in range(len(tds)):
            _equal(tds[i], jds[i])
            _equal(tego.collate_ego4d_batch([tds[i]]), jego.collate_ego4d_batch([jds[i]]))


# ---------------------------------------------------------------------------
# SFT (tests/test_extract_sft.py)
# ---------------------------------------------------------------------------
CONVS = [
    [{"from": "human", "value": "<video>\nWhat happens?"}, {"from": "gpt", "value": "A goal."},
     {"from": "human", "value": "Then?"}, {"from": "gpt", "value": "Celebration."}],
    [{"from": "gpt", "value": "dropped first"}, {"from": "human", "value": "<video>\nwho?"},
     {"from": "gpt", "value": "a player"}],
]


@pytest.mark.parametrize("i", range(len(CONVS)))
def test_sft_preprocess_matches_jax(tok, i):
    _equal(tsft.preprocess_llama2_conversations(CONVS[i], tok),
           jsft.preprocess_llama2_conversations(CONVS[i], tok))
    plain = [{"from": "human", "value": "<video>"}, {"from": "gpt", "value": "a dog runs"}]
    _equal(tsft.preprocess_plain(plain, tok), jsft.preprocess_plain(plain, tok))
    assert tsft.build_conversation_prompt(CONVS[i]) == jsft.build_conversation_prompt(CONVS[i])


@pytest.mark.parametrize("style", ["llama_2", "plain"])
def test_sft_dataset_and_collator_match_jax(tmp_path, tok, style):
    records = [
        {"id": "a", "video": "a.mp4", "conversations": [
            {"from": "human", "value": "<video>\ndescribe"},
            {"from": "gpt", "value": "something happens"}]},
        {"id": "b", "conversations": [
            {"from": "human", "value": "hello"}, {"from": "gpt", "value": "hi there friend"}]},
        {"id": "c", "image": "bad.png", "conversations": [
            {"from": "human", "value": "<image>\nwhat?"}, {"from": "gpt", "value": "a cat"}]},
    ]
    jpath = tmp_path / "sft.json"
    jpath.write_text(json.dumps(records))

    def loader(path, is_video):
        if path.endswith("bad.png"):
            raise IOError("unreadable")  # retried at a seeded random index
        return np.full((4 if is_video else 1, 3, 8, 8), len(path), np.float32)

    kw = dict(frame_loader=loader, style=style, seed=5)
    jds = jsft.VideoLLaVASFTDataset(str(jpath), str(tmp_path), tok, **kw)
    tds = tsft.VideoLLaVASFTDataset(str(jpath), str(tmp_path), tok, **kw)
    assert tds.modality_lengths == jds.modality_lengths
    items = [(tds[i], jds[i]) for i in range(len(tds))]
    for b, a in items:
        _equal(b, a)
    _equal(tsft.collate_sft_batch([b for b, _ in items[:2]], pad_token_id=0),
           jsft.collate_sft_batch([a for _, a in items[:2]], pad_token_id=0))


# ---------------------------------------------------------------------------
# feature extraction
# ---------------------------------------------------------------------------
def _fake_encode(pixels):
    t = pixels.shape[0]
    base = pixels.reshape(t, -1)[:, :8]
    return np.tile(base[:, None, :], (1, 2, 1))  # (T, 2, 8)


def _video_tree(tmp_path, name="match", frames=60, fps=10, w=128, h=96):
    vid_dir = tmp_path / "features_video" / name
    vid_dir.mkdir(parents=True)
    vpath = str(vid_dir / "1_224p.mkv")
    tnative.write_test_video(vpath, w, h, frames, fps)
    return vpath


def test_extract_window_and_restride_match_jax(tmp_path, ingest):
    vpath = _video_tree(tmp_path)
    out = {}
    for name, mod in (("jax", jextract), ("port", textract)):
        tag = f"features_video_encode_{name}"
        shards = mod.extract_video_features(vpath, _fake_encode, half=1, chunk=25, out_tag=tag)
        assert len(shards) == 3 and os.path.exists(mod.shard_path(vpath, 1, 0, 25, tag))
        full = np.concatenate([np.load(s)["features"] for s in shards])
        out[name] = dict(
            full=full, win=mod.load_feature_window(vpath, 1, 20, 40, tag),
            strided=mod.load_feature_window(vpath, 1, 0, 50, tag, stride=5),
            missing=mod.load_feature_window(vpath, 2, 0, 10, tag),
            restrided=sorted(np.load(p)["features"].tolist() for p in mod.restride_shards(
                os.path.dirname(shards[0]), src_fps=10, dst_fps=2)))
        # skip_existing: the shards are not written again
        assert mod.extract_video_features(vpath, lambda p: 1 / 0, half=1, chunk=25,
                                          out_tag=tag) == shards
    j, t = out["jax"], out["port"]
    np.testing.assert_array_equal(t["full"], j["full"])
    np.testing.assert_array_equal(t["win"], t["full"][20:40])
    np.testing.assert_array_equal(t["win"], j["win"])
    np.testing.assert_array_equal(t["strided"], j["strided"])
    assert t["missing"] is None and j["missing"] is None
    assert t["restrided"] == j["restrided"]


def test_shard_frame_loader_feeds_matchtime(tmp_path, tok, ingest):
    """Pre-extracted shards read back into MatchTimeDataset: the features are
    the shard's bytes, in both packages."""
    root = tmp_path / "features_video"
    vpath = _video_tree(tmp_path, "epl/m", frames=300, fps=25, w=64, h=48)
    lab = tmp_path / "dataset" / "MatchTime" / "train" / "epl" / "m"
    lab.mkdir(parents=True)
    (lab / "Labels-caption.json").write_text(json.dumps({"annotations": [
        {"gameTime": "1 - 00:09", "anonymized": "a shot"},
        {"gameTime": "1 - 00:11", "anonymized": "a goal"}]}))
    shards = textract.extract_video_features(vpath, _fake_encode, half=1, chunk=100)
    full = np.concatenate([np.load(s)["features"] for s in shards])
    loaders = [m.make_shard_frame_loader(video_fps=25.0, cur_fps=2.0)
               for m in (jextract, textract)]
    jds = jdata.MatchTimeDataset(str(root), tok, frame_loader=loaders[0], seed=0)
    tds = tdata.MatchTimeDataset(str(root), tok, frame_loader=loaders[1], seed=0)
    sample = tds[len(tds) - 1]
    _equal(sample, jds[len(jds) - 1])
    start, end = int(9 * 25 + 1), int(11 * 25 + 1)
    np.testing.assert_array_equal(sample["video"], full[start:end:12])
    assert sample["video"].dtype == np.float16 and sample["caption_info"] == "a goal"


@pytest.mark.parametrize("batch", [4, 16])
def test_extracted_shards_match_jax_within_one_fp16_step(tmp_path, ingest, batch):
    """The port's encode function (``make_encode_fn``: fixed batches, the
    last padded) over a tiny fp32 ViT against the JAX vit_forward on the same
    tree and the same decoded frames: shards within one fp16 step."""
    jcfg = tiny_streammind_config()
    tcfg = tconfig.tiny_streammind_config()
    jp = init_vit_params(jax.random.PRNGKey(0), jcfg.vision)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    vpath = _video_tree(tmp_path, frames=10, fps=5, w=64, h=48)
    size = jcfg.vision.image_size
    fwd = jax.jit(lambda px: vit_forward(jp, jcfg.vision, px))
    tags = ("features_video_encode_jax", "features_video_encode_port")
    jshards = jextract.extract_video_features(
        vpath, lambda px: np.asarray(fwd(px)), half=1, chunk=6, out_tag=tags[0], size=size)
    tshards = textract.extract_video_features(
        vpath, trun_extract.make_encode_fn(tp, tcfg.vision, batch=batch, device="cpu"),
        half=1, chunk=6, out_tag=tags[1], size=size)
    assert len(tshards) == len(jshards) == 2
    for ts, js in zip(tshards, jshards):
        t, j = np.load(ts)["features"], np.load(js)["features"]
        assert t.dtype == j.dtype == np.float16 and t.shape == j.shape
        # one fp16 step, beside the fp32 forwards' own difference (~1e-7 at
        # features of order 1, which rounding to fp16 can double near 0)
        step = np.spacing(np.maximum(np.abs(t), np.abs(j))).astype(np.float32) + 1e-6
        d = np.abs(t.astype(np.float32) - j.astype(np.float32))
        bad = d > step
        assert not bad.any(), (t[bad][:5], j[bad][:5], d[bad][:5], step[bad][:5])


# ---------------------------------------------------------------------------
# train(): the dataset branch
# ---------------------------------------------------------------------------
def _train_args(tmp_path, dataset, **data):
    ma = targs.ModelArguments(model_path="sp-like-tokenizer", tune_mm_mlp_adapter=True)
    da = targs.DataArguments(dataset=dataset, **data)
    ta = targs.TrainingArguments(output_dir=str(tmp_path / "out"), learning_rate=1e-3,
                                 bf16=False, logging_steps=1, max_steps=1, seed=2,
                                 device="cpu")
    return ma, da, ta


def _stub_tokenizer(monkeypatch, tok=None):
    """AutoTokenizer.from_pretrained → ``tok`` (one instance: the fake
    tokenizer numbers words in the order it first sees them)."""
    transformers = pytest.importorskip("transformers")
    asked = []
    tok = tok or SPLikeTokenizer()

    def from_pretrained(path, *a, **kw):
        asked.append(path)
        return tok

    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained", from_pretrained)
    return asked


def test_train_builds_matchtime_from_data_args(tmp_path, monkeypatch):
    """train() with no dataset= builds MatchTime from --data-path (seeded by
    --seed, at --cur-fps) and trains a step; its samples are the JAX
    dataset's built from the same arguments."""
    tok = SPLikeTokenizer()
    asked = _stub_tokenizer(monkeypatch, tok)
    root = _make_matchtime_tree(tmp_path, n_matches=1)
    s = tconfig.tiny_streammind_config().vision.image_size

    def window(self, video_path, start_ts, end_ts):  # the decoder's place
        n = max(int((end_ts - start_ts) * self.cur_fps) // 60, 1)
        return np.random.default_rng(int(end_ts)).standard_normal((n, 3, s, s)).astype(np.float32)

    built = []

    class Recording(tdata.MatchTimeDataset):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    monkeypatch.setattr(tdata.MatchTimeDataset, "_decode_window", window)
    monkeypatch.setattr(jdata.MatchTimeDataset, "_decode_window", window)
    monkeypatch.setattr(tdata, "MatchTimeDataset", Recording)
    ma, da, ta = _train_args(tmp_path, "matchtime", data_path=root, cur_fps=2.0)
    state = trun.train(ma, da, ta, cfg=tconfig.tiny_streammind_config())
    assert state.step == 1 and asked == ["sp-like-tokenizer"] and len(built) == 1
    tds = built[0]
    jds = jdata.MatchTimeDataset(root, tok, cur_fps=2.0, seed=2)
    assert len(tds) == len(jds) and tds.cur_fps == 2.0
    for i in range(len(jds)):
        _equal(tds[i], jds[i])


class _Built(Exception):
    pass


@pytest.mark.parametrize("dataset", ["ego4d", "sft"])
def test_train_builds_ego4d_and_sft_from_data_args(tmp_path, monkeypatch, dataset):
    """The Ego4D (llm, train) and SFT (plain for the adapter stage) datasets
    built from data_args as the JAX package builds them."""
    tok = SPLikeTokenizer()
    _stub_tokenizer(monkeypatch, tok)
    anno = tmp_path / "annos.json"
    anno.write_text(json.dumps({"v1": [[0.5, "You walk."], [1.5, "You stop."]]}))
    sft = tmp_path / "sft.json"
    sft.write_text(json.dumps([{"id": "a", "conversations": [
        {"from": "human", "value": "hi"}, {"from": "gpt", "value": "hello there"}]}]))
    seen = []
    mod, name, jcls, kw = {
        "ego4d": (tego, "Ego4dNarrationDataset", jego.Ego4dNarrationDataset,
                  dict(data_folder=str(tmp_path), anno_path=str(anno))),
        "sft": (tsft, "VideoLLaVASFTDataset", jsft.VideoLLaVASFTDataset,
                dict(data_path=str(sft), data_folder=str(tmp_path))),
    }[dataset]
    real = getattr(mod, name)

    class Stop(real):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen.append(self)
            raise _Built

    monkeypatch.setattr(mod, name, Stop)
    ma, da, ta = _train_args(tmp_path, dataset, **kw)
    with pytest.raises(_Built):
        trun.train(ma, da, ta, cfg=tconfig.tiny_streammind_config())
    got = seen[0]
    if dataset == "ego4d":
        want = jcls(str(tmp_path), str(anno), tok, model_type="llm", data_type="train")
        assert (got.model_type, got.data_type, got.uids) == ("llm", "train", want.uids)
    else:
        want = jcls(str(sft), str(tmp_path), tok, num_frames=ma.num_frames, style="plain",
                    seed=ta.seed)
        assert (got.style, got.num_frames) == ("plain", ma.num_frames)
    _equal(got[0], want[0])


def test_train_rejects_an_unknown_dataset(tmp_path, monkeypatch):
    _stub_tokenizer(monkeypatch)
    ma, da, ta = _train_args(tmp_path, "kinetics")
    with pytest.raises(ValueError, match="unknown dataset"):
        trun.train(ma, da, ta, cfg=tconfig.tiny_streammind_config())
