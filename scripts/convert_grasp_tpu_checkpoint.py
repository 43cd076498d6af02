#!/usr/bin/env python3
"""Convert a grasp_tpu checkpoint into the grasp_tpu_torch format.

    python scripts/convert_grasp_tpu_checkpoint.py SRC_DIR DST_DIR [--dtype bfloat16]

SRC_DIR is what ``grasp-compress --save_path`` wrote (Orbax params +
``grasp_meta.json``), so this runs where JAX and Orbax are installed. DST_DIR
gets the same ``grasp_meta.json`` (framework ``grasp_tpu_torch``) and a flat
``params.pt``, which ``grasp-serve-torch --model_path DST_DIR`` serves on a
machine without JAX. ``--dtype`` casts every floating parameter (default: keep
the saved dtypes).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def convert(src: str, dst: str, dtype: Optional[str] = None) -> str:
    import jax
    import numpy as np
    import torch

    from grasp_tpu.checkpoints import load_checkpoint
    from grasp_tpu_torch.checkpoints import save_checkpoint
    from grasp_tpu_torch.models.convert import (
        flatten_params, params_from_numpy, unflatten_params)

    params, config, plan, meta = load_checkpoint(src)
    tree = jax.tree.map(np.asarray, params)
    port = params_from_numpy(tree, "cpu", None if dtype is None else getattr(torch, dtype))
    # a restored pytree may key the layer list by position strings: normalize
    port = unflatten_params(flatten_params(port))
    if dtype is not None:
        config = dataclasses.replace(config, dtype=dtype)
    return save_checkpoint(dst, port, config, plan, rank_dict=meta.get("rank_dict"),
                           redundant_layers=meta.get("redundant_layers"),
                           layer_importances=meta.get("layer_importances"),
                           extra=meta.get("extra"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("src", help="grasp_tpu checkpoint directory")
    p.add_argument("dst", help="output directory (grasp_tpu_torch format)")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default=None)
    args = p.parse_args(argv)
    print(convert(args.src, args.dst, args.dtype))
    return 0


if __name__ == "__main__":
    sys.exit(main())
