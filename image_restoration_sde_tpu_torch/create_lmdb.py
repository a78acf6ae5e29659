"""Build an LMDB image dataset (+ meta_info.pkl) from an image folder.

    python -m image_restoration_sde_tpu_torch.create_lmdb --input datasets/Rain100H/GT \\
        --output datasets/rain100h_GT.lmdb [--name rain100h_GT]

Counterpart of ``tools/create_lmdb.py``: the layout the reference's lmdb
data path consumes (ref data/util.py:17-51: ``meta_info.pkl`` with ``keys``
and ``C_H_W`` ``resolution`` strings; raw uint8 BGR blobs keyed by file
stem), so a YAML whose dataroots end in ``lmdb`` (``data_type: lmdb``)
trains and tests on the output.  It uses the ``lmdb`` package when
importable, else the port's pure-Python MDB writer (``data/mdb.py``): the
file is standard LMDB either way, byte for byte the JAX tool's.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from .data.io_utils import get_paths_from_images, read_img


def build_lmdb(input_dir: str, output_dir: str, name: str | None = None) -> int:
    """Write every image of ``input_dir`` (sorted walk) into the LMDB root
    ``output_dir`` and its ``meta_info.pkl``; returns the image count."""
    paths = get_paths_from_images(input_dir)
    keys, resolutions, blobs = [], [], []
    for p in paths:
        img = read_img(p)  # float32 HWC RGB [0,1]
        u8 = (img * 255.0).round().astype(np.uint8)
        H, W, C = u8.shape
        blob = u8[:, :, ::-1] if C >= 3 else u8  # stored BGR like the reference tools
        keys.append(os.path.splitext(os.path.basename(p))[0])
        resolutions.append(f"{C}_{H}_{W}")
        blobs.append(np.ascontiguousarray(blob).tobytes())

    try:
        import lmdb

        env = lmdb.open(output_dir, map_size=sum(map(len, blobs)) * 2 + (1 << 22))
        with env.begin(write=True) as txn:
            for k, b in zip(keys, blobs):
                txn.put(k.encode("ascii"), b)
        env.close()
    except ImportError:
        from .data.mdb import write_items

        write_items(output_dir, zip((k.encode("ascii") for k in keys), blobs))

    meta = {"name": name or os.path.basename(output_dir), "resolution": resolutions, "keys": keys}
    with open(os.path.join(output_dir, "meta_info.pkl"), "wb") as f:
        pickle.dump(meta, f)
    return len(keys)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input", required=True, help="image folder")
    p.add_argument("--output", required=True, help="output .lmdb directory")
    p.add_argument("--name", help="dataset name stored in meta_info.pkl")
    args = p.parse_args(argv)
    n = build_lmdb(args.input, args.output, args.name)
    print(f"wrote {n} images to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
