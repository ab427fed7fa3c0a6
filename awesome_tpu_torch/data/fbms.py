"""FBMS-59 video-sequence dataset: frames, sparse multicut trajectories ->
dense weak-label masks, ground-truth annotations, label-noise injection;
counterpart of ``awesome_tpu/data/fbms.py`` (numpy and PIL, host code).

Behavior port of `awesome/dataset/fbms_sequence_dataset.py:54-892` and
`awesome/dataset/trajectory_util/*`:

- Brox tracks files ("object_id length" + length x "x y frame") parsed by
  the native C++ parser (``native/trajectory_parser.cpp``, built with g++
  at first use into ``build/awesome_tpu_torch/``, never inside
  ``native/``) with a pure-Python parser beside it
  (`fbms_sequence_dataset.py:736-789` is the Python spec),
- per-frame weak-label masks from trajectory points
  (`:358-399` trajectories_frame_to_mask),
- <Seq>Def.dat ground-truth description files (region count, labeled
  frame list; `trajectory_util/ground_truth_description_file.py`),
- probabilistic weak-label flipping for the noisy spatio-temporal
  experiments (`fbms_sequence_sample.py:706` via ``flip_probability``),
- (x, y, t) positional channels for the spatio-temporal prior
  (`awesome/dataset/transformator.py:54-60`).

Object-id convention: trajectory object id 0 is background; ids > 0 are
foreground objects. Weak-label mask encoding follows the unaries
convention: fg = 0, bg = 1, unlabeled = NaN -> handled by the callers as
"no supervision" (weight 0).
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import logging
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

TRAJ_SOURCE = (Path(__file__).resolve().parents[2] / "native"
               / "trajectory_parser.cpp")
# portable code: the library runs on whatever host loads the checkout
GXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
_TRAJ_LIB: Optional[ctypes.CDLL] = None
_TRAJ_LIB_FAILED = False


@dataclasses.dataclass
class Trajectory:
    """Spec: `awesome/dataset/trajectory_util/trajectory.py:13-30`."""

    object_id: int
    coordinates: np.ndarray  # (L, 2) as (x, y)
    frame_ids: np.ndarray  # (L,)
    line_start: int = -1


def _load_traj_lib() -> Optional[ctypes.CDLL]:
    global _TRAJ_LIB
    if _TRAJ_LIB is not None:
        return _TRAJ_LIB
    so = os.path.join(_NATIVE_DIR, "libtrajparse.so")
    try:
        if not os.path.exists(so):
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True)
        lib = ctypes.CDLL(so)
        lp = ctypes.POINTER(ctypes.c_long)
        dp = ctypes.POINTER(ctypes.c_double)
        lib.traj_count.argtypes = [ctypes.c_char_p, lp, lp]
        lib.traj_count.restype = ctypes.c_int
        lib.traj_parse.argtypes = [ctypes.c_char_p, lp, lp, dp, lp]
        lib.traj_parse.restype = ctypes.c_int
        _TRAJ_LIB = lib
        return lib
    except Exception:
        return None


def build_trajectory_parser() -> Path:
    """Compile ``native/trajectory_parser.cpp`` with g++ into
    ``build/awesome_tpu_torch/libtrajectory_parser-<hash>.so`` (the hash
    covers the source and the flags; an existing build is reused) and
    return its path."""
    from awesome_tpu_torch.ops.build import BUILD_DIR

    digest = hashlib.sha1(TRAJ_SOURCE.read_bytes())
    digest.update("\0".join(GXX_FLAGS).encode())
    out = BUILD_DIR / f"libtrajectory_parser-{digest.hexdigest()[:12]}.so"
    if out.exists():
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    res = subprocess.run([cxx, *GXX_FLAGS, "-o", str(tmp), str(TRAJ_SOURCE)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed on {TRAJ_SOURCE.name} "
                           f"({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


def _load_traj_lib() -> Optional[ctypes.CDLL]:
    """The native parser, built on first use; ``None`` (with one logged
    warning) when it cannot be built or loaded."""
    global _TRAJ_LIB, _TRAJ_LIB_FAILED
    if _TRAJ_LIB is not None or _TRAJ_LIB_FAILED:
        return _TRAJ_LIB
    try:
        lib = ctypes.CDLL(str(build_trajectory_parser()))
    except (OSError, RuntimeError) as e:
        _TRAJ_LIB_FAILED = True
        logger.warning("native trajectory parser unavailable (%s); using "
                       "the Python parser", e)
        return None
    lp = ctypes.POINTER(ctypes.c_long)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.traj_count.argtypes = [ctypes.c_char_p, lp, lp]
    lib.traj_count.restype = ctypes.c_int
    lib.traj_parse.argtypes = [ctypes.c_char_p, lp, lp, dp, lp]
    lib.traj_parse.restype = ctypes.c_int
    _TRAJ_LIB = lib
    return lib


def _parse_native(lib: ctypes.CDLL, path: str) -> Optional[List[Trajectory]]:
    n_traj = ctypes.c_long()
    n_points = ctypes.c_long()
    if lib.traj_count(path.encode(), ctypes.byref(n_traj),
                      ctypes.byref(n_points)) < 0:
        return None
    nt, npts = n_traj.value, n_points.value
    object_ids = np.zeros(nt, np.int64)
    lengths = np.zeros(nt, np.int64)
    coords = np.zeros(npts * 2, np.float64)
    frames = np.zeros(npts, np.int64)
    lp = ctypes.POINTER(ctypes.c_long)
    dp = ctypes.POINTER(ctypes.c_double)
    if lib.traj_parse(path.encode(), object_ids.ctypes.data_as(lp),
                      lengths.ctypes.data_as(lp), coords.ctypes.data_as(dp),
                      frames.ctypes.data_as(lp)) != 0:
        return None
    out = []
    off = 0
    line = 2  # the header and the count come first
    for i in range(nt):
        ln = int(lengths[i])
        out.append(Trajectory(
            object_id=int(object_ids[i]),
            coordinates=coords[2 * off:2 * (off + ln)].reshape(ln, 2),
            frame_ids=frames[off:off + ln],
            line_start=line + 1))
        off += ln
        line += 1 + ln
    return out


def parse_trajectories_file(path: str, use_native: bool = True
                            ) -> List[Trajectory]:
    """Parse a Brox tracks file: the native parser, or the Python one
    (``use_native=False``, or when the native one is unavailable).
    ``line_start`` is the 0-based line of a trajectory's first point."""
    lib = _load_traj_lib() if use_native else None
    if lib is not None:
        out = _parse_native(lib, path)
        if out is not None:
            return out
    with open(path) as f:
        lines = f.readlines()
    num = int(lines[1])
    out = []
    i = 2
    while i < len(lines):
        parts = lines[i].split()
        if not parts:
            i += 1
            continue
        oid, ln = int(parts[0]), int(parts[1])
        pts = [lines[i + 1 + k].split() for k in range(ln)]
        out.append(
            Trajectory(
                object_id=oid,
                coordinates=np.asarray(
                    [[float(p[0]), float(p[1])] for p in pts]
                ),
                frame_ids=np.asarray([int(p[2]) for p in pts]),
                line_start=i + 1,
            )
        )
        i += 1 + ln
    assert len(out) == num, f"expected {num} trajectories, got {len(out)}"
    return out


def trajectories_frame_to_mask(
    trajectories: Sequence[Trajectory],
    frame_id: int,
    image_shape: Tuple[int, int],
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-object point masks for one frame: (N_obj, H, W) + object ids.

    Spec: `fbms_sequence_dataset.py:358-399` (coordinates rounded, (x, y)
    order, indexed mask[y, x]).
    """
    h, w = image_shape
    by_obj: Dict[int, List[np.ndarray]] = {}
    for t in trajectories:
        sel = t.frame_ids == frame_id
        if sel.any():
            by_obj.setdefault(t.object_id, []).append(t.coordinates[sel])
    ids = np.asarray(sorted(by_obj))
    mask = np.zeros((len(ids), h, w), np.float32)
    for i, oid in enumerate(ids):
        pts = np.concatenate(by_obj[oid], axis=0)
        x = np.clip(np.round(pts[:, 0]).astype(int), 0, w - 1)
        y = np.clip(np.round(pts[:, 1]).astype(int), 0, h - 1)
        mask[i, y, x] = 1.0
    return mask, ids


def weak_label_unaries(
    trajectories: Sequence[Trajectory],
    frame_id: int,
    image_shape: Tuple[int, int],
    foreground_ids: Optional[Sequence[int]] = None,
    flip_probability: float = 0.0,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sparse weak-label unaries for one frame.

    Returns (unaries (H, W) with fg=0 / bg=1, labeled-mask (H, W) bool).
    Unlabeled pixels hold 1 but labeled=False (use as loss weight).
    ``flip_probability`` flips each labeled point's class — the noise
    injection of the noisy spatio-temporal experiments
    (`fbms_sequence_sample.py:706`, `fbms_sequence_dataset.py:92`).
    """
    masks, ids = trajectories_frame_to_mask(
        trajectories, frame_id, image_shape
    )
    h, w = image_shape
    unaries = np.ones((h, w), np.float32)
    labeled = np.zeros((h, w), bool)
    if len(ids) == 0:
        return unaries, labeled
    if foreground_ids is None:
        foreground_ids = [i for i in ids if i != 0]
    fg = np.zeros((h, w), bool)
    bg = np.zeros((h, w), bool)
    for i, oid in enumerate(ids):
        m = masks[i] > 0
        if oid in foreground_ids:
            fg |= m
        else:
            bg |= m
    labeled = fg | bg
    if flip_probability > 0.0:
        rng = rng or np.random.default_rng(0)
        flip = (rng.random((h, w)) < flip_probability) & labeled
        fg = np.where(flip, ~fg, fg)
    unaries[fg & labeled] = 0.0
    return unaries, labeled


def multi_object_weak_labels(
    trajectories: Sequence[Trajectory],
    frame_id: int,
    image_shape: Tuple[int, int],
    foreground_ids: Optional[Sequence[int]] = None,
    max_objects: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-OBJECT sparse weak-label unaries for one frame (the multi-object
    label mode, `awesome/dataset/label_mode.py` MULTIPLE_OBJECTS +
    `fbms_sequence_sample.py:369-420` multi-label foreground handling).

    Returns ``(unaries (K, H, W), labeled (H, W) bool, object_ids (K,))``:
    channel k holds fg=0 at object k's trajectory points and bg=1 at every
    OTHER labeled point (other objects are background for this object —
    the per-object unary the reference fits each child prior against,
    `multiple_object_aware_path_connected_net.py:211-218`). Object ids are
    the weak-label ids > 0 sorted by pixel support (largest first, the
    reference's ranking); id 0 (background) never gets a channel.
    ``max_objects`` pads/truncates K to a static capacity (extra channels
    are all-bg with id -1).
    """
    masks, ids = trajectories_frame_to_mask(
        trajectories, frame_id, image_shape
    )
    h, w = image_shape
    labeled = np.zeros((h, w), bool)
    for m in masks:
        labeled |= m > 0
    if foreground_ids is None:
        fg_ids = [int(i) for i in ids if i != 0]
    else:
        fg_ids = [int(i) for i in foreground_ids if i in ids]
    # rank by pixel support, largest first (`fbms_sequence_sample.py:383`)
    support = {
        int(oid): float((masks[j] > 0).sum())
        for j, oid in enumerate(ids)
    }
    fg_ids = sorted(fg_ids, key=lambda i: -support.get(i, 0.0))
    k = max_objects if max_objects is not None else len(fg_ids)
    unaries = np.ones((k, h, w), np.float32)
    out_ids = np.full((k,), -1, np.int64)
    id_to_mask = {int(oid): masks[j] > 0 for j, oid in enumerate(ids)}
    for c, oid in enumerate(fg_ids[:k]):
        unaries[c][id_to_mask[oid]] = 0.0
        out_ids[c] = oid
    return unaries, labeled, out_ids


def value_mask_to_channels(
    mask: np.ndarray, background_value: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Split a value-coded mask (H, W) into per-object boolean channels
    (K, H, W) + their ids, background excluded — the reference's
    ``load_mask_multi_channel`` (`fbms_sequence_sample.py:200-230`)."""
    ids = np.asarray(
        [v for v in np.unique(mask) if v != background_value]
    )
    channels = np.stack([mask == v for v in ids]) if len(ids) else (
        np.zeros((0,) + mask.shape, bool)
    )
    return channels, ids


def gt_object_id_weak_label_mapping(
    gt_channels: np.ndarray,  # (G, H, W) bool
    gt_ids: np.ndarray,  # (G,)
    weak_channels: np.ndarray,  # (K, H, W) bool
    weak_ids: np.ndarray,  # (K,)
    min_threshold: float = 0.5,
) -> "Dict[int, List[int]]":
    """GT-region -> weak-label-object id mapping by point containment.

    Port of `awesome/dataset/fbms_sequence_sample.py:779-840`
    ``_get_gt_object_id_weak_label_mapping``: GT regions (bg added as the
    complement channel, id 0) are ranked by pixel support descending; each
    maps to every weak object whose points lie >= ``min_threshold`` inside
    it, ordered by weak-object size descending.
    """
    g = len(gt_ids)
    bg = ~gt_channels.any(axis=0) if g else np.ones(
        weak_channels.shape[1:], bool
    )
    channels = np.concatenate([gt_channels, bg[None]], axis=0)
    ids = np.concatenate([np.asarray(gt_ids, np.int64), [0]])
    support = channels.reshape(len(ids), -1).sum(axis=1)
    order = np.argsort(-support)

    if len(weak_ids) == 0:
        # a GT-labeled frame can have no trajectory points at all (real
        # FBMS: GT often labels the last frame while multicut tracks end
        # earlier) — every GT region simply has no weak match
        return {int(ids[gi]): [] for gi in order}

    weak_total = weak_channels.reshape(len(weak_ids), -1).sum(axis=1)
    weak_order = np.argsort(-weak_total)
    mapping: Dict[int, List[int]] = {}
    for gi in order:
        inter = (channels[gi][None] & weak_channels).reshape(
            len(weak_ids), -1
        ).sum(axis=1)
        ratio = inter / np.maximum(weak_total, 1)
        matched = [
            int(weak_ids[wi]) for wi in weak_order
            if ratio[wi] >= min_threshold
        ]
        mapping[int(ids[gi])] = matched
    return mapping


def weak_label_id_gt_mapping(mapping: "Dict[int, List[int]]"
                             ) -> "Dict[int, int]":
    """Inverse view: weak-label id -> GT object id
    (`fbms_sequence_sample.py:253-270`)."""
    return {v: k for k, ys in mapping.items() for v in ys}


# --- ground-truth description (Def.dat) ----------------------------------


@dataclasses.dataclass
class FrameDescription:
    """One labeled frame entry. Spec:
    `trajectory_util/frame_description.py`."""

    file_name: str
    frame_index: int


@dataclasses.dataclass
class GroundTruthDescription:
    """Parsed <Seq>Def.dat. Spec:
    `trajectory_util/ground_truth_description_file.py:16-60` — we parse the
    same sections with a tolerant line-oriented scanner instead of one
    mega-regex."""

    total_number_of_regions: int = 0
    scale_of_regions: Optional[np.ndarray] = None
    confusion_penalty_matrix: Optional[np.ndarray] = None
    total_number_of_frames: int = 0
    total_number_of_labeled_frames: int = 0
    frame_descriptions: List[FrameDescription] = dataclasses.field(
        default_factory=list
    )

    @classmethod
    def from_file(cls, path: str) -> "GroundTruthDescription":
        with open(path) as f:
            lines = [ln.rstrip("\r\n") for ln in f]
        out = cls()
        i = 0
        scales: Dict[int, int] = {}
        mat_rows: List[List[float]] = []
        while i < len(lines):
            ln = lines[i].strip()
            if ln == "Total number of regions:":
                out.total_number_of_regions = int(lines[i + 1])
                i += 2
            elif ln.startswith("Scale of region"):
                m = re.match(r"Scale of region (\d+):", ln)
                scales[int(m.group(1))] = int(lines[i + 1])
                i += 2
            elif ln == "Confusion penality matrix:":
                i += 1
                while i < len(lines) and lines[i].strip() and not lines[
                    i
                ].strip()[0].isalpha():
                    mat_rows.append(
                        [float(x) for x in lines[i].split() if x]
                    )
                    i += 1
            elif ln == "Total number of frames in this shot:":
                out.total_number_of_frames = int(lines[i + 1])
                i += 2
            elif ln == "Total number of labeled frames for this shot:":
                out.total_number_of_labeled_frames = int(lines[i + 1])
                i += 2
                # remaining alternating lines: file name / frame index
                entries = [
                    l.strip() for l in lines[i:] if l.strip()
                ]
                for j in range(0, len(entries) - 1, 2):
                    out.frame_descriptions.append(
                        FrameDescription(
                            file_name=entries[j],
                            frame_index=int(entries[j + 1]),
                        )
                    )
                break
            else:
                i += 1
        if scales:
            out.scale_of_regions = np.asarray(
                [scales[k] for k in sorted(scales)]
            )
        if mat_rows:
            out.confusion_penalty_matrix = np.asarray(mat_rows)
        return out


# --- the sequence dataset ------------------------------------------------


class FBMSSequenceDataset:
    """One FBMS sequence: frames + trajectories + sparse GT.

    Directory layout (reference defaults,
    `fbms_sequence_dataset.py:80-132`): ``<seq>/`` with frame images,
    ``<seq>/GroundTruth/`` PNG masks + ``<seq>Def.dat``, and
    ``tracks/multicut/*.dat`` trajectory files.
    """

    FRAME_PATTERN = re.compile(r".*?(?P<index>\d+)\.(jpg|png|ppm|bmp)$")

    def __init__(
        self,
        dataset_path: str,
        ground_truth_dir: str = "GroundTruth",
        trajectory_dir: str = "tracks/multicut",
        trajectories_file: Optional[str] = None,
        foreground_ids: Optional[Sequence[int]] = None,
        flip_probability: float = 0.0,
        noise_seed: int = 0,
        use_memory_cache: bool = False,
        processed_weak_labels_dir: Optional[str] = None,
        do_weak_label_preprocessing: bool = False,
        confidence_dir: Optional[str] = None,
        training_batch_size: int = 1,
        validation_batch_size: int = 1,
        shuffle_in_training_dataloader: bool = True,
        shuffle_in_validation_dataloader: bool = False,
    ):
        from awesome_tpu_torch.data.batching import BatchSettings

        # per-dataset batch config (`awesome/dataset/batched_dataset.py`)
        self.batch_settings = BatchSettings(
            training_batch_size=training_batch_size,
            validation_batch_size=validation_batch_size,
            shuffle_in_training_dataloader=shuffle_in_training_dataloader,
            shuffle_in_validation_dataloader=shuffle_in_validation_dataloader,
        )
        self.dataset_path = dataset_path
        self.ground_truth_dir = ground_truth_dir
        self.trajectory_dir = trajectory_dir
        self.trajectories_file = trajectories_file
        self.foreground_ids = foreground_ids
        self.flip_probability = flip_probability
        self.noise_seed = noise_seed
        # per-frame caching (`fbms_sequence_sample.py:275-290`
        # use_memory_cache + the processed_weak_labels_dir disk cache of
        # `fbms_sequence_dataset.py`): processed weak labels are expensive
        # (outlier KD-tree + patch voting), so cache per frame
        self.use_memory_cache = use_memory_cache
        self.processed_weak_labels_dir = processed_weak_labels_dir
        self.do_weak_label_preprocessing = do_weak_label_preprocessing
        self.confidence_dir = confidence_dir
        self._weak_label_cache: dict = {}
        self._trajectories: Optional[List[Trajectory]] = None
        self.frames = self._index_frames()
        self.gt_description = self._load_gt_description()

    @property
    def sequence_name(self) -> str:
        return os.path.basename(os.path.normpath(self.dataset_path))

    def _index_frames(self) -> List[str]:
        files = []
        for f in sorted(os.listdir(self.dataset_path)):
            if self.FRAME_PATTERN.match(f):
                files.append(os.path.join(self.dataset_path, f))
        return files

    def _load_gt_description(self) -> Optional[GroundTruthDescription]:
        p = os.path.join(
            self.dataset_path,
            self.ground_truth_dir,
            self.sequence_name + "Def.dat",
        )
        if os.path.exists(p):
            return GroundTruthDescription.from_file(p)
        return None

    @property
    def trajectories(self) -> List[Trajectory]:
        if self._trajectories is None:
            tdir = os.path.join(self.dataset_path, self.trajectory_dir)
            tf = self.trajectories_file or sorted(os.listdir(tdir))[0]
            self._trajectories = parse_trajectories_file(
                os.path.join(tdir, tf)
            )
        return self._trajectories

    def __len__(self) -> int:
        return len(self.frames)

    def get_ground_truth_indices(self) -> List[int]:
        """Frame indices with dense GT. Spec:
        `fbms_sequence_dataset.py:518-525`."""
        if self.gt_description is None:
            return []
        return [fd.frame_index for fd in self.gt_description.frame_descriptions]

    def load_frame(self, index: int) -> np.ndarray:
        from PIL import Image

        img = np.asarray(Image.open(self.frames[index]), np.float64) / 255.0
        if img.ndim == 2:
            img = np.repeat(img[:, :, None], 3, -1)
        return img[:, :, :3].astype(np.float32)

    def load_ground_truth(self, frame_index: int) -> Optional[np.ndarray]:
        """Dense GT mask for a labeled frame (fg = 0 convention)."""
        if self.gt_description is None:
            return None
        for fd in self.gt_description.frame_descriptions:
            if fd.frame_index == frame_index:
                from PIL import Image

                p = os.path.join(
                    self.dataset_path, self.ground_truth_dir, fd.file_name
                )
                if not os.path.exists(p):
                    return None
                gt = np.asarray(Image.open(p))
                if gt.ndim == 3:
                    gt = gt[..., 0]
                # FBMS GT: background is the dominant label value; fg = 0
                bg_val = np.bincount(gt.reshape(-1)).argmax()
                return (gt == bg_val).astype(np.float32)
        return None

    def load_ground_truth_channels(
        self, frame_index: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Dense GT as per-object channels (G, H, W) + region ids — the
        multi-object view (`fbms_sequence_sample.py:200-230`
        load_mask_multi_channel; background = dominant value, excluded)."""
        if self.gt_description is None:
            return np.zeros((0, 0, 0), bool), np.zeros((0,), np.int64)
        for fd in self.gt_description.frame_descriptions:
            if fd.frame_index == frame_index:
                from PIL import Image

                p = os.path.join(
                    self.dataset_path, self.ground_truth_dir, fd.file_name
                )
                if not os.path.exists(p):
                    break
                gt = np.asarray(Image.open(p))
                if gt.ndim == 3:
                    gt = gt[..., 0]
                bg_val = np.bincount(gt.reshape(-1)).argmax()
                return value_mask_to_channels(
                    gt, background_value=int(bg_val)
                )
        return np.zeros((0, 0, 0), bool), np.zeros((0,), np.int64)

    def object_id_mapping(
        self, frame_index: int, min_threshold: float = 0.5
    ) -> Dict[int, List[int]]:
        """GT-region -> weak-label-object id mapping for a labeled frame
        (the multi-object correspondence of
        `fbms_sequence_dataset.py:518-554` /
        `fbms_sequence_sample.py:779-840`)."""
        img_shape = self.load_frame(frame_index).shape[:2]
        weak_masks, weak_ids = trajectories_frame_to_mask(
            self.trajectories, frame_index, img_shape
        )
        gtc, gt_ids = self.load_ground_truth_channels(frame_index)
        if gtc.size == 0:
            # no dense GT: identity mapping over weak ids (reference
            # fallback, `fbms_sequence_sample.py:795-805`)
            return {int(i): ([int(i)] if i != 0 else [])
                    for i in weak_ids}
        return gt_object_id_weak_label_mapping(
            gtc, gt_ids, weak_masks > 0, weak_ids,
            min_threshold=min_threshold,
        )

    def sample_multi(self, index: int, max_objects: int = 4
                     ) -> Dict[str, np.ndarray]:
        """Multi-object view of one frame: per-object weak unaries
        (K, H, W) with fg=0 per channel, the labeled mask, and the weak
        object ids (-1 = empty slot). The per-object channels feed one
        child prior each (`multiple_object_aware_path_connected_net.py`)."""
        img = self.load_frame(index)
        h, w = img.shape[:2]
        unaries, labeled, ids = multi_object_weak_labels(
            self.trajectories, index, (h, w),
            foreground_ids=self.foreground_ids,
            max_objects=max_objects,
        )
        return {
            "image": img,
            "object_unaries": unaries,
            "labeled": labeled,
            "object_ids": ids,
            "frame_index": index,
        }

    def _load_confidence(self, index: int) -> Optional[np.ndarray]:
        """Per-frame tracker confidence map, when present: the reference's
        h5 files (key 'confidence', `fbms_sequence_sample.py:525`) or
        .npy/.npz equivalents."""
        if self.confidence_dir is None:
            return None
        base = os.path.join(self.dataset_path, self.confidence_dir)
        stem = os.path.splitext(
            os.path.basename(self.frames[index])
        )[0]
        candidates = [
            f"{stem}.h5", f"{index:04d}.h5", f"{index}.h5",
            f"{index:04d}.npy", f"{index}.npy", f"{index:04d}.npz",
        ]
        for name in candidates:
            p = os.path.join(base, name)
            if not os.path.exists(p):
                continue
            if p.endswith(".h5"):
                import h5py

                with h5py.File(p, "r") as f:
                    return np.asarray(f["confidence"])
            data = np.load(p)
            return data["confidence"] if hasattr(data, "files") else data
        return None

    def _weak_label(self, index: int, shape) -> Tuple[np.ndarray, np.ndarray]:
        """(unaries, labeled) for one frame, with memory + disk caching of
        the (processed) weak label (`fbms_sequence_sample.py:275-290`)."""
        if self.use_memory_cache and index in self._weak_label_cache:
            return self._weak_label_cache[index]
        disk = None
        if self.processed_weak_labels_dir is not None:
            os.makedirs(self.processed_weak_labels_dir, exist_ok=True)
            disk = os.path.join(
                self.processed_weak_labels_dir,
                f"{self.sequence_name}_{index:04d}.npz",
            )
            if os.path.exists(disk):
                data = np.load(disk)
                out = (data["unaries"], data["labeled"])
                if self.use_memory_cache:
                    self._weak_label_cache[index] = out
                return out
        rng = np.random.default_rng(self.noise_seed + index)
        unaries, labeled = weak_label_unaries(
            self.trajectories,
            index,
            shape,
            foreground_ids=self.foreground_ids,
            flip_probability=self.flip_probability,
            rng=rng,
        )
        if self.do_weak_label_preprocessing:
            from awesome_tpu_torch.data.weak_label_processing import (
                process_weak_label,
            )

            unaries, labeled = process_weak_label(
                unaries, labeled,
                confidence=self._load_confidence(index),
                seed=self.noise_seed + index,
            )
        if disk is not None:
            np.savez(disk, unaries=unaries, labeled=labeled)
        if self.use_memory_cache:
            self._weak_label_cache[index] = (unaries, labeled)
        return unaries, labeled

    def sample(self, index: int) -> Dict[str, np.ndarray]:
        """Assemble one frame: image, weak unaries + labeled mask, optional
        GT, (x, y, t) positional channels."""
        from awesome_tpu_torch.data.image_sample import assemble_channels

        img = self.load_frame(index)
        h, w = img.shape[:2]
        unaries, labeled = self._weak_label(index, (h, w))
        t_max = max(len(self.frames) - 1, 1)
        xy_t = assemble_channels(img, "xy", t=float(index), t_max=float(t_max))
        return {
            "image": img,
            "unaries": unaries,
            "labeled": labeled,
            "gt": self.load_ground_truth(index),
            "xyt": xy_t,
            "frame_index": index,
        }

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.sample(index)
