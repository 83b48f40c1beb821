"""The port's data layer against the JAX package's, on the same tiny files
written to a temporary directory (16 mel bands, 16-frame windows): the ten
public dataset classes item by item with the same seeds and one worker
(ln-mels within 1e-4, as ``test_torch_stft.py``; frames, positions, masks,
audio crops and curriculum draws exact), the loader's batches and order,
the video transforms and position formulas, ``Position2DEmbedding``
through ``convert.py``, and the native WAV decoder.

One worker, because the datasets' crops and coin flips draw from a shared
``random.Random`` (or the global ``random``) in the order in which items
are made: with more threads that order, and the draws, depend on the
threads, in the JAX package as in the port."""

import csv
import gc
import random
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from scipy.io import wavfile

import diffbinaural_tpu.data as jdata
from diffbinaural_tpu import native as jnative
from diffbinaural_tpu.data import position_utils as jpos
from diffbinaural_tpu.data import video_transforms as jvt
import diffbinaural_tpu_torch.data as tdata
from diffbinaural_tpu_torch import native as tnative
from diffbinaural_tpu_torch.convert import position_embedding_params_from_flax
from diffbinaural_tpu_torch.data import position_utils as tpos
from diffbinaural_tpu_torch.data import video_transforms as tvt
from diffbinaural_tpu_torch.data.audio_io import load_wav, save_wav

from _torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)
from _torch_port_util import random_params, to_numpy_tree

SR, M, W = 22050, 16, 16  # sample rate, mel bands, window frames
MEL_TOL = 1e-4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Two 2 s clips ``a``, ``b`` (mono + binaural, FairPlay stereo), JPEG
    frames for ``a``, detections of two sources every 0.25 s for ``a``,
    split files, and the stage-2 dirs: L/R predicted mels (16 x 120)
    beside stereo wavs."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    t = np.arange(2 * SR) / SR
    for sub in ("processed/mono_audios_22050Hz",
                "processed/binaural_audios_22050Hz", "binaural_audios",
                "processed/frames/a", "splits", "action_detection_results",
                "mel_l", "mel_r", "audio", "ft_mels"):
        (root / sub).mkdir(parents=True)
    for vid, f0 in (("a", 440.0), ("b", 660.0)):
        x = (0.3 * np.sin(2 * np.pi * f0 * t)
             + 0.05 * rng.standard_normal(len(t))).astype(np.float32)
        save_wav(str(root / f"processed/mono_audios_22050Hz/{vid}.wav"), x, SR)
        stereo = np.stack([0.8 * x, 0.5 * np.roll(x, 7)]).astype(np.float32)
        save_wav(str(root / f"processed/binaural_audios_22050Hz/{vid}.wav"),
                 stereo, SR)
        save_wav(str(root / f"binaural_audios/{vid}.wav"), stereo, SR)
        save_wav(str(root / f"audio/{vid}.wav"), stereo[:, : 120 * 256], SR)
        for side in ("l", "r"):
            np.save(root / f"mel_{side}/{vid}.npy",
                    (rng.standard_normal((M, 120)) - 5).astype(np.float32))
        np.save(root / f"ft_mels/{vid}.npy",
                (rng.standard_normal((M, 172)) - 5).astype(np.float32))
    for i in range(4):
        img = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
        Image.fromarray(img).save(root / f"processed/frames/a/{i:03d}.jpg")
    for name in ("train", "val"):
        with open(root / f"splits/{name}.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["video_id", "start_time", "end_time", "action_label"])
            w.writerow(["a", "0.0", "2.0", "x"])
            w.writerow(["b", "0.5", "2.0", "y"])
    with open(root / "action_detection_results/detection_results.csv", "w",
              newline="") as f:
        w = csv.writer(f)
        w.writerow(["video_id", "time", "source", "x1", "y1", "x2", "y2"])
        for t_ in np.arange(0, 2.0, 0.25):
            w.writerow(["a", f"{t_:.2f}", "0", "0.1", "0.2", "0.4", "0.8"])
            w.writerow(["a", f"{t_:.2f}", "1", "0.6", "0.3", "0.9", "0.9"])
    with open(root / "train.txt", "w") as f:
        f.write("a|x\nb|y\n")
    return root


def assert_items_equal(got, want, mel_keys=("mono_mel", "mix_mel",
                                            "binaural_mel", "mel",
                                            "mel_loss")):
    assert set(got) == set(want)
    for k, v in want.items():
        if k in mel_keys:
            assert got[k].shape == np.shape(v), k
            np.testing.assert_allclose(got[k], v, rtol=MEL_TOL, atol=MEL_TOL,
                                       err_msg=k)
        elif isinstance(v, str):
            assert got[k] == v
        else:
            assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
            assert np.array_equal(got[k], v), k


def _stage1_kwargs(world, cls):
    det = str(world / "action_detection_results/detection_results.csv")
    kw = dict(n_mels=M, window_frames=W, num_frames=2, max_sources=3,
              seed=7)
    if cls.startswith("GenAudio"):
        audio = ("processed/mono_audios_22050Hz/a.wav"
                 if cls in ("GenAudioRealBinauralDataset", "GenAudioPosDataset")
                 else "binaural_audios/a.wav")
        return dict(audio_file=str(world / audio), stride=8, video_id="a",
                    detection_csv=det, data_root=str(world), **kw)
    return dict(csv_file=str(world / "splits/train.csv"),
                data_root=str(world), split="train",
                detection_csv=None if cls.startswith("FairPlay") else det,
                **kw)


STAGE1 = ["RealBinauralDataset", "FairPlayPosDataset",
          "FairPlayPosRightDataset", "FairPlayPosLeftDataset",
          "GenAudioRealBinauralDataset", "GenAudioFairPlayDataset",
          "GenAudioPosDataset"]


@pytest.mark.parametrize("cls", STAGE1)
def test_stage1_dataset_equals_jax(world, cls):
    kw = _stage1_kwargs(world, cls)
    got_ds, want_ds = getattr(tdata, cls)(**kw), getattr(jdata, cls)(**kw)
    assert len(got_ds) == len(want_ds) > 1
    # two passes: the train split's crops come from the dataset's own RNG
    for index in list(range(len(want_ds))) * 2:
        got, want = got_ds[index], want_ds[index]
        assert_items_equal(got, want)
    if cls == "RealBinauralDataset":  # the frames of `a` were decoded
        item = got_ds[0]
        valid = ~item["mask"]
        assert valid.any() and (~valid).any()
        for ti, ni in zip(*np.nonzero(valid)):
            assert np.abs(item["frames"][:, ti, ni]).max() > 0
    if cls == "GenAudioPosDataset":  # linear magnitudes
        assert got_ds[0]["mono_mel"].min() > 0


def test_mel_dataset_equals_jax(world):
    lists = (str(world / "train.txt"),) * 2
    wavs = str(world / "processed/binaural_audios_22050Hz")
    got_files = tdata.get_dataset_filelist(*lists, wavs)
    assert got_files == jdata.get_dataset_filelist(*lists, wavs)
    for kw in (dict(segment_size=4096), dict(segment_size=2 * SR + 512),
               dict(segment_size=4096, fine_tuning=True,
                    base_mels_path=str(world / "ft_mels"))):
        kw.update(num_mels=M, seed=3)
        got_ds = tdata.MelDataset(got_files[0], **kw)
        want_ds = jdata.MelDataset(got_files[0], **kw)
        assert got_ds.audio_files == want_ds.audio_files
        for index in (0, 1, 0):
            random.seed(11 + index)
            got = got_ds._load(index)
            random.seed(11 + index)
            want = want_ds._load(index)
            assert_items_equal(got, want)


def test_binaural_mel_dataset_equals_jax(world):
    args = (str(world / "mel_l"), str(world / "mel_r"), str(world / "audio"))
    kw = dict(segment_size=4096, num_mels=M)
    got_ds = tdata.BinauralMelSpectrogramDataset(*args, **kw)
    want_ds = jdata.BinauralMelSpectrogramDataset(*args, **kw)
    assert got_ds.valid_files == want_ds.valid_files
    assert len(got_ds) == len(want_ds) == 4
    for index in range(4):
        random.seed(index)
        got = got_ds._load(index)
        random.seed(index)
        want = want_ds._load(index)
        assert_items_equal(got, want)
    with pytest.raises(ValueError, match="No matching"):
        tdata.BinauralMelSpectrogramDataset(str(world / "audio"),
                                            *args[1:], **kw)


@pytest.mark.parametrize("epoch", [0, 20, 45, 70])
def test_binaural_combined_dataset_equals_jax(world, epoch):
    kw = dict(pred_mel_left_dir=str(world / "mel_l"),
              pred_mel_right_dir=str(world / "mel_r"), segment_size=4096,
              num_mels=M, seed=5)
    got_ds = tdata.BinauralCombinedDataset(str(world / "audio"), **kw)
    want_ds = jdata.BinauralCombinedDataset(str(world / "audio"), **kw)
    got_ds.update_epoch(epoch)
    want_ds.update_epoch(epoch)
    assert got_ds.get_pred_mel_probability() == \
        want_ds.get_pred_mel_probability()
    flips = []
    for index in [0, 1, 2, 3] * 2:
        got, want = got_ds._load(index), want_ds._load(index)
        assert_items_equal(got, want)
        flips.append(float(got["is_pred"]))
    if epoch == 0:
        assert flips == [0.0] * 8
    if epoch == 70:
        assert flips == [1.0] * 8
    # validation: predicted mels only, no draws but the crops
    val = tdata.BinauralCombinedDataset(str(world / "audio"),
                                        always_use_pred=True,
                                        use_pred_mel_schedule=False, **kw)
    assert val._load(1)["is_pred"] == 1.0


class _Counting:
    """A deterministic dataset: item i is a dict of numpy values and a
    string, the same whichever thread makes it."""

    def __init__(self, n, delay=0.0):
        self.n, self.delay = n, delay

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if self.delay:
            time.sleep(self.delay)
        return {"x": np.full((3, 2), i, np.float32), "i": i,
                "flag": np.bool_(i % 2), "name": f"item{i}"}


@pytest.mark.parametrize("shuffle,drop_last,shards", [
    (True, True, (1, 0)), (True, False, (1, 0)), (False, False, (1, 0)),
    (True, True, (2, 1)), (False, False, (3, 2))])
@pytest.mark.parametrize("workers", [1, 3])
def test_loader_batches_and_order_equal_jax(shuffle, drop_last, shards,
                                            workers):
    ds = _Counting(23)
    kw = dict(batch_size=4, shuffle=shuffle, drop_last=drop_last,
              num_workers=workers, seed=9, num_shards=shards[0],
              shard_index=shards[1])
    got_l, want_l = tdata.DataLoader(ds, **kw), jdata.DataLoader(ds, **kw)
    for epoch in range(3):
        got_l.set_epoch(epoch)
        want_l.set_epoch(epoch)
        assert len(got_l) == len(want_l)
        got, want = list(got_l), list(want_l)
        assert len(got) == len(want) == len(got_l)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                if k == "name":
                    assert g[k] == w[k]
                else:
                    assert g[k].dtype == w[k].dtype
                    assert np.array_equal(g[k], w[k])
    # an unshuffled batch is default_collate of the items, in order
    if not shuffle and shards == (1, 0):
        first = next(iter(got_l))
        want = tdata.default_collate([ds[i] for i in range(4)])
        assert all(np.array_equal(first[k], want[k]) for k in ("x", "i"))


def test_loader_iterator_stops_its_workers():
    """``next(iter(loader))`` and drop the iterator (the train CLIs do):
    the workers end instead of blocking on a full queue with a batch."""
    loader = tdata.DataLoader(_Counting(64, delay=0.002), batch_size=2,
                              num_workers=3, prefetch=1)
    it = iter(loader)
    assert list(next(it)["i"]) == [0, 1] or loader.shuffle
    threads = it.threads
    del it
    gc.collect()
    deadline = time.time() + 5
    while any(t.is_alive() for t in threads) and time.time() < deadline:
        time.sleep(0.01)
    assert not any(t.is_alive() for t in threads)
    # a closed iterator is exhausted
    it = iter(loader)
    next(it)
    it.close()
    assert list(it) == []


def test_loader_raises_a_worker_exception():
    class Broken(_Counting):
        def __getitem__(self, i):
            if i == 5:
                raise KeyError("broken item")
            return super().__getitem__(i)

    loader = tdata.DataLoader(Broken(12), batch_size=2, shuffle=False,
                              num_workers=2)
    it = iter(loader)
    assert [int(next(it)["i"][0]) for _ in range(2)] == [0, 2]
    with pytest.raises(KeyError, match="broken item"):
        next(it)


def test_loader_workers_use_one_torch_thread_each():
    seen = []

    class Probe(_Counting):
        def __getitem__(self, i):
            seen.append(torch.get_num_threads())
            return super().__getitem__(i)

    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        list(tdata.DataLoader(Probe(4), batch_size=2, num_workers=2))
        assert seen == [1] * 4
        assert torch.get_num_threads() == 2  # the consumer's own setting
    finally:
        torch.set_num_threads(before)


def test_video_transforms_equal_jax():
    rng = np.random.default_rng(4)
    for h, w in ((48, 64), (300, 200)):
        img = Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8))
        for train in (False, True):
            got = tvt.preprocess_frame(img, 32, train, random.Random(2))
            want = jvt.preprocess_frame(img, 32, train, random.Random(2))
            assert got.dtype == want.dtype and np.array_equal(got, want)
        gray = img.convert("L")
        assert np.array_equal(tvt.preprocess_frame(gray, 24),
                              jvt.preprocess_frame(gray, 24))
    frames = [rng.standard_normal((3, 4, 4)).astype(np.float32)
              for _ in range(3)]
    assert np.array_equal(tvt.stack_clip(frames), jvt.stack_clip(frames))


def test_position_formulas_equal_jax():
    rng = np.random.default_rng(6)
    ang = rng.uniform(-180, 180, (5, 3))
    p3 = rng.standard_normal((5, 3, 3))
    p2 = rng.standard_normal((5, 3, 2))
    spec = rng.standard_normal((5, 3, 4, 6))
    for name, args in (("angle_to_2d", (ang,)),
                       ("cartesian_3d_to_2d", (p3,)),
                       ("spherical_to_2d", (ang,)),
                       ("spherical_to_2d", (ang, ang / 3)),
                       ("normalize_position_data", (p2,)),
                       ("normalize_position_data", (p2, "minmax")),
                       ("normalize_position_data", (p2, "none")),
                       ("convert_existing_pos_to_2d", (p3,)),
                       ("compute_itd_factor", (p2,)),
                       ("compute_ild_factor", (p2,)),
                       ("apply_binaural_weighting", (spec, p2))):
        got = getattr(tpos, name)(*args)
        want = getattr(jpos, name)(*args)
        got, want = ((v if isinstance(v, tuple) else (v,)) for v in (got, want))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w), name


def test_position_embedding_through_convert():
    rng = np.random.default_rng(8)
    pos = rng.uniform(-1, 1, (3, 4, 2)).astype(np.float32)
    module = jpos.Position2DEmbedding(embed_dim=32)
    params = random_params(module, rng, jnp.zeros((1, 2)))
    want = np.asarray(module.apply(params, jnp.asarray(pos)))
    emb = tpos.Position2DEmbedding(embed_dim=32)
    emb.load_state_dict(
        position_embedding_params_from_flax(to_numpy_tree(params)),
        strict=True)
    with torch.no_grad():
        got = emb(torch.from_numpy(pos)).numpy()
    assert got.shape == want.shape == (3, 4, 32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_native_decoder_equals_scipy_and_jax(tmp_path):
    assert tnative.available(), tnative.build_error()
    assert tnative.library_path().exists()
    assert tnative.library_path().parent.name == "build"
    rng = np.random.default_rng(10)
    x = rng.uniform(-1, 1, (2, 3001)).astype(np.float32)
    cases = {"pcm16_stereo.wav": (x.T * 32767).astype(np.int16),
             "pcm16_mono.wav": (x[0] * 32767).astype(np.int16),
             "float_stereo.wav": x.T.copy(), "float_mono.wav": x[1].copy(),
             "pcm32_mono.wav": (x[0] * 2.0e9).astype(np.int32),
             "pcm8_mono.wav": (x[0] * 127 + 128).astype(np.uint8)}
    for name, data in cases.items():
        path = str(tmp_path / name)
        wavfile.write(path, 16000, data)
        got, sr = tnative.load_wav_native(path)
        want, want_sr = jnative.load_wav_native(path)
        assert sr == want_sr == 16000
        assert got.dtype == np.float32 and np.array_equal(got, want), name
        # load_wav goes through the decoder; scipy decodes the same values
        _, raw = wavfile.read(path)
        scale = {np.int16: 32768.0, np.int32: 2147483648.0}.get(
            raw.dtype.type)
        ref = (raw.astype(np.float32) / scale if scale
               else (raw.astype(np.float32) - 128.0) / 128.0
               if raw.dtype == np.uint8 else raw.astype(np.float32))
        ref = ref.T if ref.ndim == 2 else ref
        assert np.array_equal(load_wav(path)[0], ref), name
        assert np.array_equal(got, ref), name
    not_wav = tmp_path / "noise.wav"
    not_wav.write_bytes(b"not a riff file" * 8)
    assert tnative.load_wav_native(str(not_wav)) is None
    y = x[0].copy()
    assert np.array_equal(tnative.peak_normalize_native(y.copy(), 0.9),
                          jnative.peak_normalize_native(y.copy(), 0.9))
    assert np.array_equal(tnative.resample_native(y, 2, 3),
                          jnative.resample_native(y, 2, 3))
