"""Image-sequence enumeration and loading.

``image_filepaths_by_directory`` keeps the reference's number-aware sort
(reference: Work/python_libs/dataset_tools.py:24-65 — digit runs are
zero-padded to the longest run before lexicographic sorting, so img-2.png
precedes img-10.png). Loading uses PIL (grayscale float32, 0..255), imported
inside ``load_image_gray`` so the package imports without it.
"""

import os

import numpy as np

__all__ = ["image_filepaths_by_directory", "load_image_gray",
           "iter_images_gray"]

_EXTS = (".png", ".jpg", ".jpeg", ".tiff")


def image_filepaths_by_directory(img_dir):
    """Sorted image paths with numbers compared numerically
    (dataset_tools.py:24-65 semantics)."""
    images = [f for f in os.listdir(img_dir)
              if os.path.splitext(f)[1] in _EXTS]
    splitted = []
    max_len = 0
    for img in images:
        parts = []
        num_idxs = []
        state = None
        for ch in img:
            new_state = "num" if ch.isdigit() else "str"
            if new_state != state:
                if new_state == "num":
                    num_idxs.append(len(parts))
                parts.append("")
                state = new_state
            parts[-1] += ch
            if state == "num":
                max_len = max(max_len, len(parts[-1]))
        splitted.append((parts, num_idxs))
    keyed = []
    for img, (parts, num_idxs) in zip(images, splitted):
        for i in num_idxs:
            parts[i] = parts[i].zfill(max_len)
        keyed.append(("".join(parts), img))
    keyed.sort()
    return [os.path.join(img_dir, img) for _, img in keyed]


def load_image_gray(path):
    """Load one image as [H, W] float32 grayscale, 0..255."""
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("L"), dtype=np.float32)


def iter_images_gray(img_dir):
    """Generator over the directory's images in natural order."""
    for path in image_filepaths_by_directory(img_dir):
        yield load_image_gray(path)
