"""RNA mesh segmentation: 260-class per-vertex labels on ~15k-vertex RNA
surfaces. The counterpart of
experiments/rna_mesh_segmentation/rna_mesh_segmentation.py, the
reference's configuration (C_width 128, 4 blocks, outputs at vertices,
dropout on, xyz features with rotation augmentation by default, Adam 1e-3
halved every 50 epochs).

    python -m diffusionnet_tpu_torch.experiments.rna_mesh_segmentation.rna_mesh_segmentation \
        [--input_features xyz] [--buckets 16384,32768] [--megakernel] \
        [--device cuda] [--data_dir DIR]

The data is what experiments/rna_mesh_segmentation/prepare_data.py lays
out. --mesh DATA,VERT trains over DATA x VERT cards, one process a card:

    torchrun --nproc_per_node=DATA*VERT -m \
        diffusionnet_tpu_torch.experiments.rna_mesh_segmentation.rna_mesh_segmentation \
        --megakernel --mesh DATA,VERT

(`parallel.initialize()` joins the processes from torchrun's environment;
a process already in a torch.distributed world keeps it.)
"""

from __future__ import annotations

import argparse
import os

from ...parallel import initialize
from ..exp_common import (FitConfig, Stopwatch, add_device_arg, build_model,
                          driver_device, fit, suite_dir)
from .rna_mesh_dataset import RNAMeshDataset

SUITE = "rna_mesh_segmentation"


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_features", type=str, default="xyz")
    parser.add_argument("--n_epoch", type=int, default=200)
    parser.add_argument("--batch_size", type=int, default=2)
    parser.add_argument("--k_eig", type=int, default=128)
    parser.add_argument("--device_data", action="store_true",
                        help="keep the stacked dataset on the card and "
                             "gather batches there (no per-step host copy)")
    parser.add_argument("--megakernel", action="store_true",
                        help="the blocks on kernels B1/B2")
    parser.add_argument("--mesh", type=str, default=None, metavar="DATA,VERT",
                        help="two-axis sharded training, e.g. '2,4': the "
                             "batch over DATA ranks and every (B,V,...) "
                             "array row-sharded over VERT ranks, one "
                             "process a card (launch with torchrun "
                             "--nproc_per_node=DATA*VERT; train surfaces "
                             "larger than one card; requires --megakernel "
                             "unless VERT is 1; vertex buckets are rounded "
                             "to multiples of 128 * VERT)")
    parser.add_argument("--buckets", type=str, default=None,
                        help="comma-separated vertex bucket sizes (padded "
                             "batch shapes), e.g. '16384,32768'")
    parser.add_argument("--resume_from", type=str, default=None,
                        help="checkpoint dir: continue a stopped run")
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--data_dir", type=str, default=None,
                        help=f"dataset root (default: experiments/{SUITE}/"
                             "data)")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    if args.mesh:
        initialize()
    device = driver_device(args.device)

    dataset_path = args.data_dir or os.path.join(suite_dir(SUITE), "data")
    op_cache_dir = os.path.join(dataset_path, "op_cache")
    model_save_path = os.path.join(
        dataset_path, "saved_models", f"rna_seg_{args.input_features}_4x128")
    sw, stages = Stopwatch(), {}

    with sw("precompute"):
        train_dataset = RNAMeshDataset(dataset_path, train=True,
                                       k_eig=args.k_eig,
                                       op_cache_dir=op_cache_dir,
                                       device=device, timings=stages)
        test_dataset = RNAMeshDataset(dataset_path, train=False,
                                      k_eig=args.k_eig,
                                      op_cache_dir=op_cache_dir,
                                      device=device, timings=stages)
    mesh_shape = (tuple(int(s) for s in args.mesh.split(","))
                  if args.mesh else None)
    buckets = (tuple(int(s) for s in args.buckets.split(","))
               if args.buckets else None)
    cfg = FitConfig(
        n_epoch=args.n_epoch, lr=1e-3, decay_every=50, decay_rate=0.5,
        batch_size=args.batch_size, input_features=args.input_features,
        augment_rotate=(args.input_features == "xyz"), labels_kind="vertex",
        use_megakernel=args.megakernel, bf16=args.bf16,
        device_data=args.device_data, mesh_shape=mesh_shape, buckets=buckets,
        graceful_sigterm=True)
    model = build_model(n_class=260, c_width=128, outputs_at="vertices",
                        dropout=True, input_features=args.input_features,
                        bf16=args.bf16)
    with sw("fit"):
        params, history, evaluate = fit(
            model, train_dataset, test_dataset, cfg,
            model_save_path=model_save_path,
            log_path=model_save_path + "_log.jsonl",
            resume_from=args.resume_from, device=device)
    with sw("evaluate"):
        acc = evaluate(params, test_dataset)
    print(f"Overall test accuracy: {100 * acc:06.3f}%")
    return {"model_save_path": model_save_path, "test_acc": acc,
            "history": history, "seconds": sw.seconds,
            "precompute_stages": stages}


if __name__ == "__main__":
    main()
