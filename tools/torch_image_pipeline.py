#!/usr/bin/env python3
"""How fast the host feeds the vision zoo's fit: the input pipeline of
``chip_smoke.py``'s ``vision_zoo`` phase without the card.

    python3 tools/torch_image_pipeline.py

Writes the phase's 832 JPEG files (``chip_smoke._write_jpegs``) to a
temporary directory, then prints the CPU count, the ms an image of the
phase's transforms in this process (decode alone, and each transform),
and the arrival times of the 13 batches of 64 through the port's
DataLoader with seven and with four worker processes. Nothing here
touches CUDA.
"""
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import chip_smoke as cs
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.vision import transforms as T

    print("cpus", os.cpu_count(), "affinity", len(os.sched_getaffinity(0)))
    tmp = tempfile.mkdtemp()
    try:
        n = cs.RN_BATCH * (cs.ZOO_WARMUP + cs.ZOO_TIMED)
        print("write s", cs._write_jpegs(tmp, n, 0))
        tf = T.Compose([T.RandomResizedCrop(cs.RN_SIZE),
                        T.RandomHorizontalFlip(), T.ToTensor(),
                        T.Normalize(cs.ZOO_MEAN, cs.ZOO_STD)])
        data = cs._LabelledFolder(tmp, tf)
        t = time.perf_counter()
        for i in range(32):
            data[i]
        print("per image ms (one process)",
              (time.perf_counter() - t) / 32 * 1e3)
        raw = cs._LabelledFolder(tmp, None)
        t = time.perf_counter()
        for i in range(32):
            raw[i]
        print("decode only ms", (time.perf_counter() - t) / 32 * 1e3)
        img = raw[0][0]
        for name, f in (("rrc", T.RandomResizedCrop(cs.RN_SIZE)),
                        ("flip", T.RandomHorizontalFlip()),
                        ("totensor", T.ToTensor())):
            t = time.perf_counter()
            for _ in range(32):
                f(img)
            print(name, (time.perf_counter() - t) / 32 * 1e3)
        for workers in (7, 4):
            loader = DataLoader(data, batch_size=cs.RN_BATCH, shuffle=True,
                                drop_last=True, num_workers=workers)
            t = time.perf_counter()
            arrivals = [time.perf_counter() - t for _ in loader]
            print("workers", workers, "arrivals",
                  [round(x, 2) for x in arrivals])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
