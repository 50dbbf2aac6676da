"""Build a packed raw-frame store (``data/frame_store.py``) for a dataset.

The port's counterpart of the JAX package's ``tools/build_frame_store.py``,
over the port's data copies. It replays the production decode+crop path
once and writes (N, H, W, 3) uint8 to a memmap-able .npy, in dataset item
order. Afterwards the host pipeline reads frames with zero decode
(``config.data.{train,val}_frame_store``)::

  python -m contextaware_poseformer_tpu_torch.tools.build_frame_store h36m \\
      --labels h36m_train.pkl --root data/h36m/images \\
      --out /fast/h36m_train_frames.npy
  python -m contextaware_poseformer_tpu_torch.tools.build_frame_store \\
      3dhp_train --npz data_train_3dhp.npz \\
      --root .../mpi_inf_3dhp/images --out /fast/3dhp_train_frames.npy
  python -m contextaware_poseformer_tpu_torch.tools.build_frame_store \\
      3dhp_test --npz data_test_3dhp.npz \\
      --root .../mpi_inf_3dhp_test_set/images --out /fast/3dhp_test.npy

H36M stores are built over the FULL pickle (no --retain) so one store
serves any retain_every_n view; 3DHP stores must be built with the same
keep_invalid the consumer will use (length-validated at open).
"""

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dataset", choices=["h36m", "3dhp_train", "3dhp_test"])
    ap.add_argument("--labels", help="h36m labels pickle")
    ap.add_argument("--npz", help="3dhp packed npz")
    ap.add_argument("--root", required=True, help="images root")
    ap.add_argument("--out", required=True, help="output .npy path")
    ap.add_argument("--image-shape", type=int, nargs=2, default=(256, 192),
                    metavar=("H", "W"))
    ap.add_argument("--precropped", action="store_true",
                    help="h36m images on disk are already crops")
    ap.add_argument("--keep-invalid", action="store_true",
                    help="3dhp_test: retain invalid frames (multi-frame "
                         "window consumers)")
    ap.add_argument("--batch", type=int, default=256)
    args = ap.parse_args(argv)

    from contextaware_poseformer_tpu_torch.data import frame_store

    if args.dataset == "h36m":
        from contextaware_poseformer_tpu_torch.data.h36m import H36MDataset

        ds = H36MDataset.from_pickle(
            args.labels, args.root, tuple(args.image_shape),
            precropped=args.precropped,
        )
    else:
        from contextaware_poseformer_tpu_torch.data import mpi3dhp

        if args.dataset == "3dhp_train":
            ds = mpi3dhp.load_train(args.npz, args.root)
        else:
            ds = mpi3dhp.load_test(args.npz, args.root,
                                   keep_invalid=args.keep_invalid)
    t0 = time.time()
    frame_store.build_store(ds, args.out, batch_size=args.batch)
    dt = time.time() - t0
    print(f"wrote {len(ds)} frames to {args.out} in {dt:.1f}s "
          f"({len(ds) / max(dt, 1e-9):.0f} img/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
