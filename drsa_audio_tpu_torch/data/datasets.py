"""Dataset lists, offline loaders and training feeds (the port of
drsa_audio_tpu.data.datasets).

Fold and split files, per-genre song lists, the clip -> log-mel loaders of
the extraction and evaluation batches, and the raw-waveform feeds of
training, whose augmentation and mel run on the device inside the train
step (models.train). Decoding is the native one of runtime.loader, with no
fallback; the DSP runs on the device the caller names (CUDA unless named).
"""

from __future__ import annotations

import os
import random as pyrandom
from typing import Dict, List

import numpy as np
import torch

from drsa_audio_tpu_torch.ops.frontend import FrontendConfig, chunk_startpoints, load_clip_to_mels
from drsa_audio_tpu_torch.runtime.loader import load_audio, prefetch_batches
from drsa_audio_tpu_torch.utils.constants import AUDIO_PARAMS, CLASS_IDX_MAPPER, CLASS_IDX_MAPPER_TOY
from drsa_audio_tpu_torch.utils.device import resolve_device


# ------------------------------------------------------- list utilities

def get_songs_of_genre(path: str, genre: str, excluded_folds=None,
                       num_folds: int = 5) -> List[str]:
    """All paths of a genre across folds: fold files at
    {path}/{num_folds}folds/fold_k.txt, audio under {path}/genres_original/."""
    songpaths = []
    for fold in range(1, num_folds + 1):
        if excluded_folds is not None and fold in excluded_folds:
            continue
        fname = os.path.join(path, f"{num_folds}folds", f"fold_{fold}.txt")
        with open(fname) as f:
            for line in f:
                line = line.strip()
                if line and line.split("/")[0] == genre:
                    songpaths.append(os.path.join(path, "genres_original", line))
    return songpaths


def get_songlist(path: str, genre: str | None = None, excluded_folds=None,
                 num_folds: int = 5, return_list: bool = True,
                 genres: Dict[str, int] = CLASS_IDX_MAPPER):
    """Songs of one genre or all, as one list or {genre: list}."""
    keys = [genre] if genre else list(genres)
    if return_list:
        out: list = []
        for key in keys:
            out.extend(get_songs_of_genre(path, key, excluded_folds, num_folds))
        return out
    return {key: get_songs_of_genre(path, key, excluded_folds, num_folds)
            for key in keys}


def get_toy_samplelist(path: str, toyclass: str | None = None,
                       splits=None) -> List[str]:
    """Paths of the toy split lists ({split}_split.txt), of one class or all."""
    splits = ["train", "valid", "test"] if splits is None else [splits]
    samplelist = []
    for split in splits:
        with open(os.path.join(path, f"{split}_split.txt")) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if toyclass and line.split("/")[0] != toyclass:
                    continue
                samplelist.append(os.path.join(path, line))
    return samplelist


def shuffle_and_truncate(data_batch: np.ndarray, songlist: List[str],
                         N: int, seed: int = 42, startpoints=None):
    """Seeded permutation, then the first N; with per-chunk ``startpoints``
    they are permuted alongside and a 3-tuple is returned."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(data_batch))
    data_batch = data_batch[perm][:N]
    songs = [songlist[i] for i in perm[:N]]
    if startpoints is not None:
        return data_batch, songs, np.asarray(startpoints)[perm[:N]]
    return data_batch, songs


def get_songlist_random(path: str, num_folds: int = 5) -> List[str]:
    """All fold lists ({path}/fold_k.txt) concatenated."""
    songs = []
    for fold in range(1, num_folds + 1):
        with open(os.path.join(path, f"fold_{fold}.txt")) as f:
            songs.extend(line.strip() for line in f if line.strip())
    return songs


# --------------------------------------------------------- batch loaders

class Loader:
    """Offline clip -> log-mel loader: decode on the host, DSP on
    ``device``; mels come back as numpy."""

    def __init__(self, case: str = "gtzan", device=None):
        self.config = FrontendConfig.for_case(case)
        self.device = resolve_device(device, "Loader")

    def load(self, path_to_audio: str, num_chunks: int = 1,
             startpoint: float = 0, return_wav: bool = False):
        wav, sr = load_audio(path_to_audio)
        if sr != self.config.sample_rate:
            raise ValueError(f"{path_to_audio}: sample rate {sr}, expected "
                             f"{self.config.sample_rate}")
        with torch.no_grad():
            mels = load_clip_to_mels(torch.as_tensor(wav, device=self.device), self.config,
                                     startpoint=startpoint, num_chunks=num_chunks)
        mels = mels.cpu().numpy()
        if return_wav:
            return wav, mels
        return mels

    def load_batch(self, songlist: List[str], startpoints=None):
        if startpoints is None:
            startpoints = np.zeros(len(songlist))
        out = [self.load(p, startpoint=s) for p, s in zip(songlist, startpoints)]
        return np.concatenate(out, axis=0)


def get_songs_drsa(datapath: str, sample_class: str, excluded_folds=None,
                   N=None, num_folds: int = 5, num_chunks: int = 10,
                   case: str = "gtzan", num_songs: int | None = None,
                   seed: int = 42, device=None):
    """The extraction batch of one genre: ``num_chunks`` chunks a song, with
    the song path and startpoint (seconds) of every chunk. ``num_songs``
    caps the (seeded-shuffled) song list before loading; ``N`` truncates at
    the chunk level after it (``shuffle_and_truncate``). Returns (data
    [M, 1, h, w], songs [M], startpoints [M])."""
    paths = get_songlist(datapath, sample_class, excluded_folds, num_folds)
    if num_songs is not None and num_songs < len(paths):
        local = pyrandom.Random(seed)
        paths = list(paths)
        local.shuffle(paths)
        paths = paths[:num_songs]
    loader = Loader(case, device)
    cfg = loader.config
    chunk_starts = chunk_startpoints(cfg.slice_length, num_chunks, cfg.sample_rate)
    batch, songs, starts = [], [], []
    for p in paths:
        batch.append(loader.load(p, num_chunks=num_chunks))
        songs.extend([p] * num_chunks)
        starts.extend(chunk_starts.tolist())
    data = np.concatenate(batch, axis=0)
    starts = np.asarray(starts)
    if N:
        data, songs, starts = shuffle_and_truncate(data, songs, N, startpoints=starts)
    return data, songs, starts


def get_songs_toy(datapath: str, sample_class: str, split=None, N=None,
                  seed: int = 42, device=None):
    """The toy extraction batch of one class: (mels, paths)."""
    paths = get_toy_samplelist(datapath, sample_class, split)
    if N is not None:
        rng = pyrandom.Random(seed)
        rng.shuffle(paths)
        paths = paths[:N]
    loader = Loader("toy", device)
    return np.concatenate([loader.load(p) for p in paths], axis=0), paths


def get_data_main(datapath: str, samples_per_class: int, fold=None,
                  genre=None, num_chunks: int = 1, num_folds: int = 5,
                  seed: int = 42, genres: Dict[str, int] = CLASS_IDX_MAPPER,
                  case: str = "gtzan", device=None):
    """The balanced evaluation batch: ``samples_per_class`` clips a genre
    (of ``fold`` only where given) x ``num_chunks`` slices, in class order,
    from a local seeded shuffle. Returns (mels, the clips' paths)."""
    exclude = (list(np.delete(np.arange(1, num_folds + 1), fold - 1))
               if fold else None)
    sample_dict = get_songlist(datapath, genre, exclude, num_folds,
                               return_list=False, genres=genres)
    local = pyrandom.Random(seed)
    loader = Loader(case, device)
    batch, loaded = [], []
    for samplelist in sample_dict.values():
        samplelist = list(samplelist)
        local.shuffle(samplelist)
        if samples_per_class > len(samplelist):
            raise ValueError(f"get_data_main: {samples_per_class} clips a class asked, "
                             f"{len(samplelist)} there")
        for i in range(samples_per_class):
            batch.append(loader.load(samplelist[i], num_chunks=num_chunks))
            loaded.append(samplelist[i])
    return np.concatenate(batch, axis=0), loaded


# --------------------------------------------------- training batch feeds

class ToyWaveDataset:
    """The toy training feed: (waveforms [b, 16000], labels [b]) as numpy,
    decoded once each and cached; shuffled from a numpy seed on the train
    split."""

    def __init__(self, data_path: str, split: str, batch_size: int = 16,
                 seed: int = 42, drop_last: bool = False):
        self.paths = get_toy_samplelist(data_path, splits=split)
        self.labels = np.array(
            [CLASS_IDX_MAPPER_TOY[os.path.basename(os.path.dirname(p))]
             for p in self.paths], np.int32)
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.shuffle = split == "train"
        self.drop_last = drop_last
        self._cache: dict = {}

    def _wave(self, path):
        if path not in self._cache:
            wav, _ = load_audio(path)
            self._cache[path] = wav[0].astype(np.float32)
        return self._cache[path]

    def __iter__(self):
        idx = np.arange(len(self.paths))
        if self.shuffle:
            self.rng.shuffle(idx)
        for i in range(0, len(idx), self.batch_size):
            sel = idx[i:i + self.batch_size]
            if self.drop_last and len(sel) < self.batch_size:
                break
            wavs = np.stack([self._wave(self.paths[j]) for j in sel])
            yield wavs, self.labels[sel]


def get_toydata_loaders(data_path: str, batch_size: int = 16, seed: int = 42):
    """(train, valid, test) toy feeds."""
    return (ToyWaveDataset(data_path, "train", batch_size, seed),
            ToyWaveDataset(data_path, "valid", batch_size, seed),
            ToyWaveDataset(data_path, "test", batch_size, seed))


def get_data_loaders(data_path: str, batch_size: int = 16,
                     validation_fold: int = 1, seed: int = 42):
    """(train, valid) GTZAN feeds; the valid feed batches whole clips (cut
    them with models.train.valid_chunks_to_mels)."""
    vbs = max(batch_size // AUDIO_PARAMS["gtzan"]["num_chunks"], 1)
    return (GtzanWaveDataset(data_path, "train", validation_fold, batch_size, seed=seed),
            GtzanWaveDataset(data_path, "valid", validation_fold, vbs, seed=seed))


class GtzanWaveDataset:
    """The GTZAN training feed: (29 s waveforms [b, 464,000], labels [b]),
    shuffled from a numpy seed on the train split (fold ``validation_fold``
    held out; the valid split is that fold).

    Each WAV is decoded once (native threads, runtime.loader.
    prefetch_batches) into one host array, and later epochs copy from it;
    ``cache=False`` streams from disk instead. With ``device_cache`` the
    decoded corpus is copied to ``device`` once and each batch, waveforms
    and labels, is gathered there with ``index_select``: only the index
    vector crosses to the card. Without it, batches are numpy."""

    def __init__(self, data_path: str, split: str, validation_fold: int = 1,
                 batch_size: int = 16, num_folds: int = 5, seed: int = 42,
                 cache: bool = True, num_threads: int = 4,
                 device_cache: bool = False, device=None):
        self.paths, labels = [], []
        for genre, label in CLASS_IDX_MAPPER.items():
            if split == "train":
                excluded = [validation_fold]
            else:
                excluded = [f for f in range(1, num_folds + 1) if f != validation_fold]
            for p in get_songs_of_genre(data_path, genre, excluded, num_folds):
                self.paths.append(p)
                labels.append(label)
        self.labels = np.array(labels, np.int32)
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.shuffle = split == "train"
        self.min_len = 29 * 16000
        self.num_threads = num_threads
        self._cache: np.ndarray | None = None
        self._use_cache = cache or device_cache
        self._device = resolve_device(device, "GtzanWaveDataset") if device_cache else None
        self._dcache = None
        self._dlabels = None

    def _fix_len(self, w: np.ndarray) -> np.ndarray:
        w = w.astype(np.float32, copy=False)
        if len(w) < self.min_len:
            w = np.pad(w, (0, self.min_len - len(w)))
        return w[: self.min_len]

    def preload(self):
        """Decode the whole corpus once (threaded) into one [N, 29 s] array."""
        if not self._use_cache or self._cache is not None:
            return self
        self._cache = np.empty((len(self.paths), self.min_len), np.float32)
        i = 0
        for batch in prefetch_batches(self.paths, 64, self.num_threads):
            for wav in batch:
                self._cache[i] = self._fix_len(np.asarray(wav)[0])
                i += 1
        if i != len(self.paths):
            raise RuntimeError(f"GtzanWaveDataset: decoded {i} of {len(self.paths)} files")
        return self

    def _wave(self, path):
        wav, _ = load_audio(path)
        return self._fix_len(wav[0])

    def __iter__(self):
        if self._use_cache:
            self.preload()
        if self._device is not None and self._dcache is None:
            self._dcache = torch.as_tensor(self._cache, device=self._device)
            self._dlabels = torch.as_tensor(self.labels, device=self._device)
        idx = np.arange(len(self.paths))
        if self.shuffle:
            self.rng.shuffle(idx)
        for i in range(0, len(idx), self.batch_size):
            sel = idx[i:i + self.batch_size]
            if self._dcache is not None:
                dsel = torch.as_tensor(sel, device=self._device)
                yield self._dcache.index_select(0, dsel), self._dlabels.index_select(0, dsel)
            elif self._cache is not None:
                yield self._cache[sel], self.labels[sel]
            else:
                yield np.stack([self._wave(self.paths[j]) for j in sel]), self.labels[sel]
