"""Per-clip average optical-flow magnitude: the dataset's shot filter.

The port of create_dataset/average_flow.py: the RGB SpyNet
(``MESpynet(luma_mode=False)``, six levels) between the first and the
middle frame of every clip under ``<data>/sequences/*/*``, and the mean
|flow| of each, written to a JSON of the same keys ("<seq>/<clip>");
the statistics drive the motion-balanced clip selection. Weights from a
SpyNet torch checkpoint (``--spynet``, sniklaus or reference names), or
seeded (torch.Generator, seed 0) without one. Runs on CUDA unless
--device cpu.

    python -m learned_pmctf_tpu_torch.cli.average_flow --data DIR \\
        --out flow_stats.json [--spynet ckpt]
"""

from __future__ import annotations

import argparse
import glob
import json
import os.path as osp
import sys

import numpy as np
import torch


def parse_args(argv):
    p = argparse.ArgumentParser(description="average optical flow a clip (PyTorch)")
    p.add_argument("--data", required=True, help="vimeo-32 root")
    p.add_argument("--out", default="flow_stats.json")
    p.add_argument("--spynet", default=None,
                   help="a SpyNet torch checkpoint (RGB conv1)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


@torch.no_grad()
def main(argv):
    args = parse_args(argv)
    from PIL import Image

    from ..convert import load_reference_spynet
    from ..models.layers import init_params
    from ..models.spynet import MESpynet
    from ..runtime import disable_tf32, resolve_device

    device = resolve_device(args.device)
    disable_tf32()
    model = init_params(MESpynet(levels=6, luma_mode=False),
                        torch.Generator().manual_seed(0))
    if args.spynet:
        load_reference_spynet(args.spynet, model)
    model = model.to(device).eval()

    def load(path):
        img = np.asarray(Image.open(path).convert("RGB"), np.float32)
        return torch.from_numpy(img.transpose(2, 0, 1).copy())[None].to(device) / 255.0

    stats = {}
    for folder in sorted(glob.iglob(osp.join(args.data, "sequences", "*", "*"))):
        ims = sorted(glob.glob(osp.join(folder, "*.png")))
        if len(ims) < 2:
            continue
        flow = model(load(ims[0]), load(ims[len(ims) // 2]))
        stats["/".join(folder.split("/")[-2:])] = float(
            torch.mean(torch.sqrt(flow[:, 0] ** 2 + flow[:, 1] ** 2)))

    with open(args.out, "w") as f:
        json.dump(stats, f, indent=2)
    vals = np.array(list(stats.values()))
    print(f"{len(stats)} clips; mean |flow| {vals.mean():.3f} "
          f"median {np.median(vals):.3f}")
    return stats


if __name__ == "__main__":
    main(sys.argv[1:])
