"""Stage-1 audio-visual datasets — counterpart of
``diffbinaural_tpu/data/stage1.py``: ``RealBinauralDataset``, the three
FairPlay variants and the three full-clip ``GenAudio*`` window datasets,
over two bases (``_Stage1Base``, ``_GenAudioBase``).

Batch keys:
    mono_mel / mix_mel : (1, M, W) raw ln-mel window (W = 80 frames)
    binaural_mel       : (2, M, W) ln-mel L/R target
    frames             : (3, T, N, 224, 224) CLIP-preprocessed crops
    pos_data           : (T, N, 3) distance / elevation / azimuth
    2d_pos_data        : (T, N, 2) elevation / azimuth
    mask               : (T, N) bool, True = invalid / padded source
  and for the ``GenAudio*`` items: total_time_frame, start_time_frame.

Frontend: sr 22050, n_fft 1024, hop 256, win 1024, ln-clamp — the port's
``mel_spectrogram`` on CPU tensors (``meldataset._MelFrontend``).

Detection CSV: ``video_id,time,source,x1,y1,x2,y2[,distance,elevation,
azimuth]`` with box coordinates in [0, 1]; rows without angles derive them
from the box centre.  Frames live at ``{data_root}/processed/frames/
{video_id}/`` (or ``{data_root}/frames/{video_id}/``), one image file per
frame in sorted order.  A crop is decoded with Pillow and CLIP-preprocessed
with its bicubic resize, so the frames equal the JAX package's bit for bit;
a crop that fails to decode stays zero, as it does there.  Without Pillow,
``_visual`` raises an ``ImportError`` naming it as soon as a frame is to be
decoded; a world with no frame directories (the missing-media path) needs
no Pillow: its frames are zero, its positions and masks come from the
detections.

Randomness: the train-split crops of ``RealBinauralDataset`` and the
FairPlay datasets draw from one ``random.Random(seed)`` per dataset, in the
JAX package's calls and order; with one loader worker the crops equal its
crops, with more they depend on the threads' order, there as here.
"""

from __future__ import annotations

import csv
import glob
import os
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from .audio_io import load_wav
from ..infer.stage1 import window_starts
from .meldataset import _MelFrontend
from .video_transforms import CLIP_MEAN, CLIP_STD, pil_image

WINDOW_FRAMES = 80
MAX_SOURCES = 4
IMG_SIZE = 224


def load_split_csv(path: str) -> List[Dict[str, str]]:
    """``video_id,start_time,end_time,action_label`` rows; a headerless
    file is read as one video id per line (its first column)."""
    rows = []
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        if reader.fieldnames and "video_id" in reader.fieldnames:
            for r in reader:
                rows.append(r)
        else:  # headerless / first-column-only lists
            f.seek(0)
            for line in f:
                line = line.strip()
                if line:
                    rows.append({"video_id": line.split(",")[0]})
    return rows


def load_detection_csv(path: str) -> Dict[str, List[Dict]]:
    """Group detection rows by video_id; tolerate missing files/columns."""
    out: Dict[str, List[Dict]] = {}
    if not path or not os.path.exists(path):
        return out
    with open(path, newline="") as f:
        for r in csv.DictReader(f):
            vid = r.get("video_id") or r.get("video") or ""
            out.setdefault(vid, []).append(r)
    return out


def _clip_preprocess(img: np.ndarray) -> np.ndarray:
    """HWC uint8 → CLIP-normalised (3, 224, 224) float32: bicubic resize
    of the shorter side to 224, centre crop."""
    Image = pil_image()
    pil = Image.fromarray(img)
    w, h = pil.size
    scale = IMG_SIZE / min(w, h)
    pil = pil.resize((round(w * scale), round(h * scale)), Image.BICUBIC)
    w, h = pil.size
    left, top = (w - IMG_SIZE) // 2, (h - IMG_SIZE) // 2
    pil = pil.crop((left, top, left + IMG_SIZE, top + IMG_SIZE))
    arr = np.asarray(pil, np.float32) / 255.0
    arr = (arr - CLIP_MEAN) / CLIP_STD
    return arr.transpose(2, 0, 1)


class _Stage1Base:
    """Shared machinery: mel windows + frame/position assembly."""

    def __init__(
        self,
        csv_file: str,
        data_root: str,
        detection_csv: Optional[str] = None,
        sample_rate: int = 22050,
        audio_len: int = 16384,
        n_mels: int = 80,
        n_fft: int = 1024,
        hop: int = 256,
        win: int = 1024,
        split: str = "train",
        num_frames: int = 5,
        max_sources: int = MAX_SOURCES,
        simple_frames: bool = False,
        seed: int = 1234,
        window_frames: int = WINDOW_FRAMES,
    ):
        self.rows = load_split_csv(csv_file)
        self.data_root = data_root
        self.detections = load_detection_csv(detection_csv)
        self.sample_rate = sample_rate
        self.audio_len = audio_len
        self.hop = hop
        self.split = split
        self.num_frames = num_frames
        self.max_sources = max_sources
        self.simple_frames = simple_frames
        self._rng = random.Random(seed)
        self.mel = _MelFrontend(n_fft, n_mels, sample_rate, hop, win, 0.0, None)
        self.n_mels = n_mels
        # production window is 80 frames; tests shrink it to keep the CPU
        # world small
        self.window_frames = window_frames

    def __len__(self):
        return len(self.rows)

    # ---- audio --------------------------------------------------------

    def _mel_window(self, audio: np.ndarray, start_frame: int) -> np.ndarray:
        """(C?, T) audio → ln-mel (.., 80, 80) window at start_frame."""
        mel = self.mel(audio) if audio.ndim == 1 else np.stack(
            [self.mel(ch) for ch in audio]
        )
        sl = slice(start_frame, start_frame + self.window_frames)
        out = mel[..., sl]
        pad = self.window_frames - out.shape[-1]
        if pad > 0:
            out = np.pad(
                out,
                [(0, 0)] * (out.ndim - 1) + [(0, pad)],
                constant_values=np.log(1e-5),
            )
        return out.astype(np.float32)

    # ---- frames + positions -------------------------------------------

    def _frame_dir(self, video_id: str) -> Optional[str]:
        for cand in (
            os.path.join(self.data_root, "processed", "frames", video_id),
            os.path.join(self.data_root, "frames", video_id),
        ):
            if os.path.isdir(cand):
                return cand
        return None

    def _visual(
        self, video_id: str, t0: float, t1: float
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """→ frames (3, T, N, 224, 224), pos3 (T, N, 3), pos2 (T, N, 2),
        mask (T, N).  Missing media yields zero frames + all-invalid mask —
        the encoders' null paths handle it."""
        T, N = self.num_frames, self.max_sources
        frames = np.zeros((3, T, N, IMG_SIZE, IMG_SIZE), np.float32)
        pos3 = np.zeros((T, N, 3), np.float32)
        pos2 = np.zeros((T, N, 2), np.float32)
        mask = np.ones((T, N), bool)  # True = invalid

        dets = self.detections.get(video_id, [])
        frame_dir = self._frame_dir(video_id)
        frame_files = (
            sorted(glob.glob(os.path.join(frame_dir, "*")))
            if frame_dir
            else []
        )

        det_times = sorted({float(d.get("time", 0)) for d in dets})
        times = np.linspace(t0, t1, T)
        for ti, t in enumerate(times):
            if not det_times:
                break
            # snap to the nearest detection timestamp, one row per source id
            t_near = min(det_times, key=lambda dt: abs(dt - t))
            if abs(t_near - t) > 1.0:
                continue
            by_source = {}
            for d in dets:
                if abs(float(d.get("time", 0)) - t_near) < 1e-6:
                    by_source.setdefault(int(d.get("source", 0)), d)
            near = [by_source[k] for k in sorted(by_source)][:N]
            for ni, d in enumerate(near):
                x1 = float(d.get("x1", 0.25))
                y1 = float(d.get("y1", 0.25))
                x2 = float(d.get("x2", 0.75))
                y2 = float(d.get("y2", 0.75))
                cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
                dist = float(d.get("distance", 1.0))
                elev = float(d.get("elevation", (0.5 - cy) * 90.0))
                azim = float(d.get("azimuth", (cx - 0.5) * 180.0))
                pos3[ti, ni] = (dist, elev, azim)
                pos2[ti, ni] = (elev, azim)
                mask[ti, ni] = False
                if frame_files and not self.simple_frames:
                    Image = pil_image()
                    idx = min(
                        int(t / max(t1, 1e-6) * len(frame_files)),
                        len(frame_files) - 1,
                    )
                    try:
                        img = np.asarray(
                            Image.open(frame_files[idx]).convert("RGB")
                        )
                        h, w = img.shape[:2]
                        crop = img[
                            int(y1 * h) : max(int(y2 * h), int(y1 * h) + 8),
                            int(x1 * w) : max(int(x2 * w), int(x1 * w) + 8),
                        ]
                        frames[:, ti, ni] = _clip_preprocess(crop)
                    except Exception:
                        pass
        return frames, pos3, pos2, mask


class RealBinauralDataset(_Stage1Base):
    """RealBinaural: ``processed/{mono,binaural}_audios_22050Hz/{vid}.wav``
    and frames under ``data_root``; key ``mono_mel``."""

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        row = self.rows[index]
        vid = row["video_id"]
        mono_path = self._audio_path("mono_audios_22050Hz", vid)
        bin_path = self._audio_path("binaural_audios_22050Hz", vid)
        mono, _ = load_wav(mono_path, target_sr=self.sample_rate)
        if mono.ndim == 2:
            mono = mono.mean(axis=0)
        binaural, _ = load_wav(bin_path, target_sr=self.sample_rate)
        if binaural.ndim == 1:
            binaural = np.stack([binaural, binaural])

        total_frames = min(len(mono), binaural.shape[1]) // self.hop
        if self.split == "train" and total_frames > self.window_frames:
            start = self._rng.randint(0, total_frames - self.window_frames)
        else:
            start = 0

        t0 = float(row.get("start_time", 0.0)) + start * self.hop / self.sample_rate
        dur = self.window_frames * self.hop / self.sample_rate
        frames, pos3, pos2, mask = self._visual(vid, t0, t0 + dur)

        return {
            "mono_mel": self._mel_window(mono, start)[None],
            "binaural_mel": self._mel_window(binaural, start),
            "frames": frames,
            "pos_data": pos3,
            "2d_pos_data": pos2,
            "mask": mask,
        }

    def _audio_path(self, sub: str, vid: str) -> str:
        for cand in (
            os.path.join(self.data_root, "processed", sub, vid + ".wav"),
            os.path.join(self.data_root, sub, vid + ".wav"),
            os.path.join(self.data_root, "processed", sub, vid),
        ):
            if os.path.exists(cand):
                return cand
        raise FileNotFoundError(f"{sub}/{vid}.wav under {self.data_root}")


class FairPlayPosDataset(_Stage1Base):
    """FairPlay: stereo binaural wavs; the mono mix is (L+R)/2, batch key
    ``mix_mel``."""

    audio_subdir = "binaural_audios"
    swap_channels = False

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        row = self.rows[index]
        vid = row["video_id"]
        path = None
        for cand in (
            os.path.join(self.data_root, self.audio_subdir, vid + ".wav"),
            os.path.join(self.data_root, "processed", self.audio_subdir,
                         vid + ".wav"),
            os.path.join(self.data_root, vid + ".wav"),
        ):
            if os.path.exists(cand):
                path = cand
                break
        if path is None:
            raise FileNotFoundError(f"{vid}.wav under {self.data_root}")
        stereo, _ = load_wav(path, target_sr=self.sample_rate)
        if stereo.ndim == 1:
            stereo = np.stack([stereo, stereo])
        if self.swap_channels:
            stereo = stereo[::-1].copy()
        mix = stereo.mean(axis=0)

        total_frames = stereo.shape[1] // self.hop
        if self.split == "train" and total_frames > self.window_frames:
            start = self._rng.randint(0, total_frames - self.window_frames)
        else:
            start = 0

        t0 = float(row.get("start_time", 0.0)) + start * self.hop / self.sample_rate
        dur = self.window_frames * self.hop / self.sample_rate
        frames, pos3, pos2, mask = self._visual(vid, t0, t0 + dur)

        return {
            "mix_mel": self._mel_window(mix, start)[None],
            "binaural_mel": self._mel_window(stereo, start),
            "frames": frames,
            "pos_data": pos3,
            "2d_pos_data": pos2,
            "mask": mask,
        }


class FairPlayPosRightDataset(FairPlayPosDataset):
    """Channel-swapped targets (right-ear-first ordering)."""

    swap_channels = True


class FairPlayPosLeftDataset(FairPlayPosDataset):
    """The canonical left-ear-first ordering (== the base dataset)."""

    swap_channels = False


class _GenAudioBase(_Stage1Base):
    """Full-clip windowed inference datasets (the test CLIs): every item is
    one 80-frame window, at ``infer.stage1.window_starts`` offsets, with
    start / total frame metadata."""

    mel_key = "mono_mel"

    def __init__(self, audio_file: str, stride: int = 40, video_id: str = "",
                 detection_csv: Optional[str] = None, data_root: str = "",
                 **kw):
        # bypass csv loading: a single clip
        self.rows = [{"video_id": video_id or
                      os.path.splitext(os.path.basename(audio_file))[0]}]
        self.data_root = data_root
        self.detections = load_detection_csv(detection_csv)
        self.sample_rate = kw.get("sample_rate", 22050)
        self.audio_len = kw.get("audio_len", 16384)
        self.hop = kw.get("hop", 256)
        self.split = "test"
        self.num_frames = kw.get("num_frames", 5)
        self.max_sources = kw.get("max_sources", MAX_SOURCES)
        self.simple_frames = kw.get("simple_frames", False)
        self._rng = random.Random(kw.get("seed", 1234))
        self.n_mels = kw.get("n_mels", 80)
        self.window_frames = kw.get("window_frames", WINDOW_FRAMES)
        self.mel = _MelFrontend(
            kw.get("n_fft", 1024), self.n_mels, self.sample_rate, self.hop,
            kw.get("win", 1024), 0.0, None,
        )

        audio, _ = load_wav(audio_file, target_sr=self.sample_rate)
        if audio.ndim == 2:
            audio = audio.mean(axis=0)
        self.audio = audio
        self.full_mel = self.mel(audio)  # (80, total)
        self.total_time_frame = self.full_mel.shape[1]
        self.starts = window_starts(
            self.total_time_frame, self.window_frames, stride
        )

    def __len__(self):
        return len(self.starts)

    def __getitem__(self, index):
        start = self.starts[index]
        window = self.full_mel[:, start : start + self.window_frames]
        pad = self.window_frames - window.shape[1]
        if pad > 0:
            window = np.pad(window, ((0, 0), (0, pad)),
                            constant_values=np.log(1e-5))
        vid = self.rows[0]["video_id"]
        t0 = start * self.hop / self.sample_rate
        dur = self.window_frames * self.hop / self.sample_rate
        frames, pos3, pos2, mask = self._visual(vid, t0, t0 + dur)
        return {
            self.mel_key: window[None].astype(np.float32),
            "frames": frames,
            "pos_data": pos3,
            "2d_pos_data": pos2,
            "mask": mask,
            "total_time_frame": np.int32(self.total_time_frame),
            "start_time_frame": np.int32(start),
        }


class GenAudioRealBinauralDataset(_GenAudioBase):
    """RealBinaural clips, key ``mono_mel``."""

    mel_key = "mono_mel"


class GenAudioFairPlayDataset(_GenAudioBase):
    """FairPlay clips, key ``mix_mel``."""

    mel_key = "mix_mel"


class GenAudioPosDataset(_GenAudioBase):
    """The legacy path whose wrapper applies log1p(mel)·0.167 itself, so
    this dataset yields RAW linear mel magnitudes."""

    mel_key = "mono_mel"

    def __getitem__(self, index):
        item = super().__getitem__(index)
        item[self.mel_key] = np.exp(item[self.mel_key])  # ln-mel → linear mel
        return item
