"""AirSim-MAP multi-view loader (reference: ptsemseg/loader/airsim_loader.py).

The port's own copy of ``multiagentperception_tpu/data/airsim.py``; keep the
two in step. It decodes with cv2 where cv2 imports, else with the port's
native libpng decoder (``native.py``), memoizes decoded frames
(``cache_decoded``), degrades the requester's view online (``noisy_type``,
``data/noise.py``) and augments (``data/augmentations.py``). The split plots
(JAX's ``plot_splits``) are left out: matplotlib is no part of the port.

Behavioral parity with the reference Dataset:

- identical trajectory-level train/val/test split: per-region greedy split by
  trajectory distance with ``random.seed(2019)`` shuffling
  (airsim_loader.py:292-341);
- identical frame indexing: a frame is kept iff it exists in *all* cameras x
  *both* modalities (airsim_loader.py:233-256);
- identical normalization: RGB->BGR, subtract the ImageNet-ish mean
  [103.939, 116.779, 123.68], /255 when ``img_norm`` (airsim_loader.py:515-540)
  — kept HWC, the layout of the port's public batches;
- identical communication-label parsing for 'when2com' and 'mimo'
  (airsim_loader.py:412-438).

The city-graph edge table and class color tables are dataset metadata loaded
from ``airsim_map_meta.json`` (``NAME2COLOR`` / ``NAME2ID`` / ``ID2NAME``,
the reference's airsim_loader.py:48-73), which ``decode_segmap`` and
``visual.py`` read.
"""

from __future__ import annotations

import copy
import glob
import json
import os
import random
import threading
import zlib
from ast import literal_eval as make_tuple

import numpy as np

from multiagentperception_tpu_torch.data.noise import NOISE_TYPES, generate_noise

_META_PATH = os.path.join(os.path.dirname(__file__), "airsim_map_meta.json")

with open(_META_PATH) as _f:
    _META = json.load(_f)

ALL_EDGES = [((e[0][0], e[0][1]), (e[1][0], e[1][1])) for e in _META["all_edges"]]
NAME2COLOR = _META["name2color"]
NAME2ID = _META["name2id"]
ID2NAME = {i: n for n, i in NAME2ID.items()}

SPLITS = ("train", "val", "test")
IMAGE_MODES = ("scene", "segmentation_decoded")
WEATHER = "async_rotate_fog_000_clear"
MEAN_RGB = np.array([103.939, 116.779, 123.68])
IGNORE_INDEX = 0
N_CLASSES = 11


def label_region_and_distance(i, edge):
    """Label an edge with its city region and length
    (reference: airsim_loader.py:19-40)."""
    begin, end = edge
    distance = ((begin[0] - end[0]) ** 2 + (begin[1] - end[1]) ** 2) ** 0.5
    if begin[0] <= -400 or end[0] < -400:
        region = "suburban"
    elif begin[1] >= 300 or end[1] >= 300:
        region = "shopping"
    else:
        region = "skyscraper"
    return (i, begin, end, distance, region)


def divide_region_train_val_test():
    """Deterministic 25/25/50 test/val/train split by trajectory distance,
    greedy after a seed-2019 shuffle (reference: airsim_loader.py:292-341)."""
    region_dict = {r: [0.0, []] for r in ("skyscraper", "suburban", "shopping")}
    dataset_div = {
        s: {r: [0.0, []] for r in ("skyscraper", "suburban", "shopping")}
        for s in SPLITS
    }
    processed = [label_region_and_distance(i, e) for i, e in enumerate(ALL_EDGES)]
    for p in processed:
        region_dict[p[4]][1].append(p)
        region_dict[p[4]][0] += p[3]

    test_ratio, val_ratio = 0.25, 0.25
    for region, (total_distance, path_list) in region_dict.items():
        test_distance = total_distance * test_ratio
        val_distance = total_distance * val_ratio
        tem_list = copy.deepcopy(path_list)
        random.seed(2019)
        random.shuffle(tem_list)
        sum_distance = 0.0
        while sum_distance < test_distance * 0.8:
            path = tem_list.pop()
            sum_distance += path[3]
            dataset_div["test"][region][0] += path[3]
            dataset_div["test"][region][1].append(path)
        while sum_distance < (test_distance + val_distance) * 0.8:
            path = tem_list.pop()
            sum_distance += path[3]
            dataset_div["val"][region][0] += path[3]
            dataset_div["val"][region][1].append(path)
        dataset_div["train"][region][0] = total_distance - sum_distance
        dataset_div["train"][region][1] = tem_list
    return dataset_div


def tuple_to_folder_name(path_tuple):
    """Edge tuple -> on-disk trajectory dir glob (airsim_loader.py:265-269).
    Note the y sign flip."""
    start, end = path_tuple[1], path_tuple[2]
    return f"{start[0]}_{-start[1]}__{end[0]}_{-end[1]}*"


def generate_split_subdirs(dataset_div=None):
    """Split -> list of trajectory dir globs (airsim_loader.py:270-291)."""
    if dataset_div is None:
        dataset_div = divide_region_train_val_test()
    out = {}
    for split in SPLITS:
        subdirs = []
        for region in ("skyscraper", "suburban", "shopping"):
            for path in dataset_div[split][region][1]:
                subdirs.append(tuple_to_folder_name(path))
        out[split] = subdirs
    return out


def get_cam_pos(target_view: str):
    """Named camera-set layouts (reference: airsim_loader.py:452-475)."""
    layouts = {
        "overhead": ["overhead", "front", "back", "left", "right"],
        "front": ["front", "back", "left", "right", "overhead"],
        "back": ["back", "front", "left", "right", "overhead"],
        "left": ["left", "back", "front", "right", "overhead"],
        "target": ["target", "normal1", "normal2", "normal3", "normal4"],
        "6agent": ["agent1", "agent2", "agent3", "agent4", "agent5", "agent6"],
        "5agent": ["agent1", "agent2", "agent3", "agent4", "agent5"],
        "DroneNP": ["DroneNN_main", "DroneNP_main", "DronePN_main",
                    "DronePP_main", "DroneZZ_main"],
        "DroneNN_backNN": ["DroneNN_backNN", "DroneNP_backNP", "DronePN_backPN",
                           "DroneNN_frontNN", "DroneNP_frontNP"],
        "5agentv7": ["agent1", "agent3", "agent5", "agent2", "agent4"],
    }
    return layouts.get(target_view, ["front", "back", "left", "right", "overhead"])


def _resolve_decoder(use_native_decoder: bool | None) -> bool:
    """Whether to decode natively: JAX's choice for None (cv2 where it
    imports, else native; data/airsim.py:221-230), with no quiet fallback.
    A decoder that cannot run raises here."""
    from multiagentperception_tpu_torch import native

    if use_native_decoder is None:
        try:
            import cv2  # noqa: F401
        except ImportError as cv2_err:
            try:
                native.load()
            except (native.NativeBuildError, OSError) as err:
                raise RuntimeError(f"no PNG decoder: cv2 does not import ({cv2_err}) and the "
                                   f"native decoder does not build or load ({err})") from err
            return True
        return False
    if use_native_decoder:
        native.load()  # NativeBuildError with the compiler's stderr, or OSError
    return bool(use_native_decoder)


def read_selection_label(root: str, label_type: str):
    """Parse gt_when_to_communicate.txt / gt_mimo_communicate.txt
    (reference: airsim_loader.py:412-438). Keys are '<traj_dir>/<frame>.png'.
    """
    def _open_label(name, fmt):
        path = os.path.join(root, name)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"data.commun_label='{label_type}' needs the ground-truth "
                f"communication labels at '{path}' (format: {fmt}); ship it "
                f"with the dataset or set commun_label: None")
        return open(path)

    if label_type == "when2com":
        com_label = {}
        with _open_label("gt_when_to_communicate.txt",
                         "'<idx> <label> .../<traj>/<cam>/<frame>' per "
                         "line") as f:
            for x in f:
                parts = x.split(" ")
                p = parts[2].strip().split("/")
                com_label[p[-3] + "/" + p[-1] + ".png"] = int(parts[1])
        return com_label
    if label_type == "mimo":
        com_label = {}
        with _open_label("gt_mimo_communicate.txt",
                         "'(<noise vec>) (<link vec>) .../<traj>/<cam>/"
                         "<frame>' per line") as f:
            for x in f:
                p = x.split(" ")[-1].strip().split("/")
                key = p[-3] + "/" + p[-1] + ".png"
                noise_label = make_tuple(x.split(" (")[0])
                link_label = make_tuple(x.split(") ")[1] + ")")
                com_label[key] = np.array([noise_label, link_label], dtype=np.int64)
        return com_label
    raise ValueError(f"Unknown label file name {label_type}")


class AirsimDataset:
    """Index + decode AirSim-MAP multi-view frames.

    ``__getitem__`` returns ``(images (N, H, W, 3) float32,
    labels (N, H, W) int32[, com_label])`` — the agent axis stacked, NHWC.
    With ``raw_images`` the images stay uint8 RGB and are normalized on the
    device (ops/normalize.py).

    - ``noisy_type`` degrades the requester's view (agent 0) before
      augmentation and normalization (``data/noise.py``).
    - ``augmentations``: a ``data.augmentations.Compose`` applied to each
      view with its mask.
    - ``use_native_decoder``: None (default) decodes with cv2 where it
      imports, else with the native decoder; True the native decoder, False
      cv2. A decoder that cannot run raises when the dataset is made: with
      neither, an error naming both; with True, the compiler's error.
    - ``cache_decoded``: a directory; each frame's decoded uint8 block
      (N, H, W, 4), the mask as a 4th channel, is saved there as
      ``{split}_{index}_{crc32 of its first scene path:08x}.npy`` on first
      touch and read by mmap afterwards, the JAX package's names and layout,
      so either package reads the other's cache.

    A deliberate difference from the JAX copy: the gaussian noise and the
    augmentations draw from generators derived from (``seed``, epoch,
    index), not from the global ``random`` module or an unseeded numpy
    generator, so worker processes and a resumed run reproduce a stream.
    The epoch is ``set_epoch``'s (the loaders set it); ``load(index,
    epoch)`` takes it explicitly.
    """

    def __init__(
        self,
        root: str,
        split: str = "train",
        img_size=(512, 512),
        augmentations=None,
        img_norm: bool = True,
        commun_label: str = "None",
        target_view: str = "target",
        raw_images: bool = False,
        noisy_type: str | None = None,
        use_native_decoder: bool | None = None,
        cache_decoded: str | None = None,
        seed: int = 0,
    ):
        self.root = root
        self.split = split
        self.raw_images = raw_images
        self.noisy_type = None if noisy_type in (None, "None") else noisy_type
        if self.noisy_type is not None and self.noisy_type not in NOISE_TYPES:
            raise ValueError(f"Unknown noise type {noisy_type}")
        self.use_native_decoder = _resolve_decoder(use_native_decoder)
        self.cache_decoded = cache_decoded
        if cache_decoded:
            os.makedirs(cache_decoded, exist_ok=True)
        self.img_size = img_size if isinstance(img_size, tuple) else (img_size, img_size)
        self.augmentations = augmentations
        self.img_norm = img_norm
        self.commun_label = commun_label
        self.n_classes = N_CLASSES
        self.mean = MEAN_RGB
        self.cam_pos = get_cam_pos(target_view)
        self.split_subdirs = generate_split_subdirs()
        self.seed = int(seed)
        self.epoch = 0
        self._geometry: dict[str, tuple[int, int, int]] = {}  # modality -> native (w, h, c)

        comm_label = None
        if commun_label != "None":
            comm_label = read_selection_label(root, commun_label)

        # Existence-intersection indexing (airsim_loader.py:233-256): keep a
        # frame iff it exists for every camera in both modalities.
        self.imgs = {
            s: {c: {m: [] for m in IMAGE_MODES} for c in self.cam_pos}
            for s in SPLITS
        }
        self.com_label = {s: [] for s in SPLITS}
        for s in SPLITS:
            for subdir in self.split_subdirs[s]:
                pattern = os.path.join(
                    root, "scene", WEATHER, subdir, self.cam_pos[0], "*.png"
                )
                for file_path in sorted(glob.glob(pattern, recursive=True)):
                    ext = file_path.replace(root + "/scene/", "")
                    file_name = ext.split("/")[-1]
                    path_dir = ext.split("/")[1]
                    all_present = all(
                        os.path.exists(
                            os.path.join(root, modal, WEATHER, path_dir, cam, file_name)
                        )
                        for modal in IMAGE_MODES
                        for cam in self.cam_pos
                    )
                    if not all_present:
                        continue
                    for modal in IMAGE_MODES:
                        for cam in self.cam_pos:
                            self.imgs[s][cam][modal].append(
                                os.path.join(root, modal, WEATHER, path_dir, cam, file_name)
                            )
                    if comm_label is not None:
                        self.com_label[s].append(comm_label[path_dir + "/" + file_name])

        if not self.imgs[self.split][self.cam_pos[0]][IMAGE_MODES[0]]:
            raise RuntimeError(
                f"No files for split=[{self.split}] found in {self.root}"
            )

    def __len__(self):
        return len(self.imgs[self.split][self.cam_pos[0]][IMAGE_MODES[0]])

    def set_epoch(self, epoch: int) -> None:
        """The epoch the next ``__getitem__`` calls draw their randomness for."""
        self.epoch = int(epoch)

    def _read_pair(self, index, camera):
        import cv2

        img_path = self.imgs[self.split][camera]["scene"][index]
        mask_path = self.imgs[self.split][camera]["segmentation_decoded"][index]
        img = np.asarray(cv2.imread(img_path), dtype=np.uint8)[:, :, :3]
        mask = np.asarray(cv2.imread(mask_path), dtype=np.uint8)[:, :, 0]
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        return img, mask

    def transform(self, img: np.ndarray, lbl: np.ndarray):
        """Normalization (airsim_loader.py:515-540), HWC output."""
        img = img[:, :, ::-1].astype(np.float64)  # RGB -> BGR
        img -= self.mean
        if self.img_norm:
            img = img / 255.0
        lbl = lbl.astype(np.int64)
        if not np.all(np.unique(lbl[lbl != IGNORE_INDEX]) < self.n_classes):
            raise ValueError("Segmentation map contained invalid class values")
        return img.astype(np.float32), lbl.astype(np.int32)

    def _native_batch(self, modal: str, index: int) -> np.ndarray:
        """Every view of one modality in one concurrent native call; the
        geometry is probed on the split's first decode and held to after."""
        from multiagentperception_tpu_torch import native

        paths = [self.imgs[self.split][cam][modal][index] for cam in self.cam_pos]
        if modal not in self._geometry:
            self._geometry[modal] = native.png_info(paths[0])
        w, h, c = self._geometry[modal]
        return native.decode_batch(paths, h, w, c)

    def _read_all_native(self, index):
        """(N, H, W, 3) scenes and (N, H, W) masks in two native calls."""
        scenes = self._native_batch("scene", index)[..., :3]
        masks = self._native_batch("segmentation_decoded", index)
        # the reference takes cv2's BGR channel 0, blue, RGB channel 2
        # (airsim_loader.py:498); a one-channel PNG decodes to gray -> RGB
        masks = masks[..., 2 if masks.shape[-1] >= 3 else 0]
        return scenes, masks

    def _cache_path(self, index):
        # stable across processes (Python hash() is salted per run)
        key = self.imgs[self.split][self.cam_pos[0]]["scene"][index]
        crc = zlib.crc32(key.encode()) & 0xFFFFFFFF
        return os.path.join(self.cache_decoded, f"{self.split}_{index}_{crc:08x}.npy")

    def _decode_all(self, index):
        """(N, H, W, 3) uint8 scenes + (N, H, W) uint8 masks for a frame."""
        if self.use_native_decoder:
            scenes, masks = self._read_all_native(index)
            return np.ascontiguousarray(scenes), np.ascontiguousarray(masks)
        scenes, masks = [], []
        for cam in self.cam_pos:
            img, m = self._read_pair(index, cam)
            scenes.append(img)
            masks.append(m)
        return np.stack(scenes), np.stack(masks)

    def _cached(self, index):
        """The frame's decoded block from the cache, written on first touch."""
        cp = self._cache_path(index)
        if os.path.exists(cp):
            # one .npy, the mask packed as a 4th channel; mmap serves it
            # straight from the page cache
            block = np.load(cp, mmap_mode="r")
            return block[..., :3], block[..., 3]
        scenes, masks = self._decode_all(index)
        block = np.concatenate([scenes, masks[..., None]], axis=-1).astype(np.uint8)
        # a name of its own per process and thread: worker processes and an
        # epoch's wrap may decode one frame at once, and with a shared name
        # the losing writer's os.replace would find no file. The trailing
        # .npy keeps np.save from appending its own; os.replace is atomic.
        tmp = f"{cp}.{os.getpid()}.{threading.get_ident()}.tmp.npy"
        np.save(tmp, block)
        os.replace(tmp, cp)
        return scenes, masks

    def __getitem__(self, index):
        return self.load(index, self.epoch)

    def load(self, index: int, epoch: int):
        """Frame ``index`` with the randomness of ``epoch``."""
        index = int(index)
        if self.cache_decoded:
            scenes, masks = self._cached(index)
        else:
            scenes, masks = self._decode_all(index)
        if self.raw_images and self.augmentations is None and self.noisy_type is None:
            # fast path: the decoded block is already the output layout
            images, labels = np.ascontiguousarray(scenes), masks.astype(np.int32)
        else:
            images, labels = self._assemble(scenes, masks, index, epoch)
        if self.commun_label != "None":
            return images, labels, self.com_label[self.split][index]
        return images, labels

    def _rngs(self, index: int, epoch: int) -> tuple[np.random.Generator, random.Random]:
        """The frame's noise generator and augmentation generator."""
        noise = np.random.default_rng([self.seed, epoch, index, 0])
        aug = random.Random(int(np.random.SeedSequence([self.seed, epoch, index, 1])
                                .generate_state(1, np.uint64)[0]))
        return noise, aug

    def _assemble(self, scenes, masks, index, epoch):
        """Noise (agent 0), augmentation and transform on a decoded block."""
        noise_rng, aug_rng = self._rngs(index, epoch)
        imgs, lbls = [], []
        for k in range(len(self.cam_pos)):
            img, lbl = scenes[k], masks[k]
            if k == 0 and self.noisy_type is not None:
                img = generate_noise(img, self.noisy_type, noise_rng)
            if self.augmentations is not None:
                img, lbl = self.augmentations(img, lbl, aug_rng)
            if self.raw_images:
                img, lbl = np.asarray(img), lbl.astype(np.int32)
            else:
                img, lbl = self.transform(img, lbl)
            imgs.append(img)
            lbls.append(lbl)
        return np.stack(imgs, axis=0), np.stack(lbls, axis=0)

    def decode_segmap(self, temp: np.ndarray) -> np.ndarray:
        """Class map -> RGB in [0, 1] for visualization (airsim_loader.py:542-555)."""
        rgb = np.zeros((temp.shape[0], temp.shape[1], 3))
        for i, name in ID2NAME.items():
            color = NAME2COLOR[name][0]
            for c in range(3):
                rgb[:, :, c][temp == i] = color[c] / 255.0
        return rgb
