"""NNImageReader — directory of images → DataFrame (port of
``nnframes/nn_image_reader.py``, host code copied).

The image column holds the decoded HWC uint8 array, beside origin, height
and width columns. pandas and PIL are imported inside ``readImages``.
"""

from __future__ import annotations

import glob
import os
from typing import List

import numpy as np

_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".gif")


class NNImageReader:
    @staticmethod
    def readImages(path: str, resizeH: int = -1, resizeW: int = -1,
                   with_label_from_dirs: bool = False):
        """Read images under ``path`` (a dir, a glob, or comma-separated paths)
        into a pandas DataFrame with columns image/origin/height/width
        (+``label`` when ``with_label_from_dirs``: subdirectory name index, the
        dogs-vs-cats style layout)."""
        import pandas as pd
        from PIL import Image

        files: List[str] = []
        for part in str(path).split(","):
            part = part.strip()
            if os.path.isdir(part):
                for root, _dirs, names in os.walk(part):
                    files.extend(os.path.join(root, n) for n in names
                                 if n.lower().endswith(_EXTS))
            else:
                # explicit file or glob: the user named it — no extension
                # filtering (PIL decodes more formats than _EXTS lists), but
                # only regular files (globs like 'dir/*' also match subdirs)
                files.extend(f for f in glob.glob(part) if os.path.isfile(f))
        files = sorted(set(files))
        if not files:
            raise FileNotFoundError(f"no images found under {path!r}")

        label_names = None
        if with_label_from_dirs:
            label_names = sorted({os.path.basename(os.path.dirname(f))
                                  for f in files})

        rows = []
        for f in files:
            img = Image.open(f).convert("RGB")
            if resizeH > 0 and resizeW > 0:
                img = img.resize((resizeW, resizeH))
            arr = np.asarray(img, dtype=np.uint8)
            row = {"image": arr, "origin": f,
                   "height": arr.shape[0], "width": arr.shape[1]}
            if label_names is not None:
                row["label"] = label_names.index(
                    os.path.basename(os.path.dirname(f)))
            rows.append(row)
        return pd.DataFrame(rows)

    read_images = readImages


__all__ = ["NNImageReader"]
