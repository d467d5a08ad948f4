"""Offline dataset preparation: raw KITTI or Cityscapes -> the scene
folders the train CLI reads; the counterpart of
cc_tpu/cli/prepare_train_data.py, with the same flags, defaults and prints.

python -m cc_tpu_torch.cli.prepare_train_data RAW_DIR \\
    --dataset-format kitti --dump-root DUMP --width 832 --height 256 \\
    --num-threads 4 [--with-gt] \\
    [--static-frames cc_tpu_torch/data/lists/static_frames.txt]

Host only (numpy and cv2). Scenes are dumped by a pool of --num-threads
threads: cv2 releases the interpreter lock while it decodes, resizes and
encodes, and each scene writes only its own folder, so the files are the
same for any thread count.
"""
from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor

from cc_tpu_torch.data.etl import (
    CityscapesLoader, KittiRawLoader, dump_scene, write_split,
)

parser = argparse.ArgumentParser()
parser.add_argument("dataset_dir", metavar="DIR")
parser.add_argument("--dataset-format", required=True,
                    choices=["kitti", "cityscapes"])
parser.add_argument("--static-frames", default=None)
parser.add_argument("--with-gt", action="store_true")
parser.add_argument("--dump-root", required=True)
parser.add_argument("--height", type=int, default=128)
parser.add_argument("--width", type=int, default=416)
parser.add_argument("--num-threads", type=int, default=4)


def main(argv=None) -> None:
    args = parser.parse_args(argv)
    os.makedirs(args.dump_root, exist_ok=True)
    if args.dataset_format == "kitti":
        loader = KittiRawLoader(args.dataset_dir,
                                static_frames_file=args.static_frames,
                                img_height=args.height,
                                img_width=args.width, get_gt=args.with_gt)
    else:
        loader = CityscapesLoader(args.dataset_dir, img_height=args.height,
                                  img_width=args.width)

    print(f"Retrieving frames from {len(loader.scenes)} scenes")
    with ThreadPoolExecutor(args.num_threads) as pool:
        futures = [pool.submit(dump_scene, loader, scene, args.dump_root)
                   for scene in loader.scenes]
        for f in futures:
            f.result()  # a scene's failure raises here
    print("Generating train/val lists")
    write_split(args.dump_root)


if __name__ == "__main__":
    main()
