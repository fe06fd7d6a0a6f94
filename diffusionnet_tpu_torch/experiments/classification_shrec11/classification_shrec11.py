"""SHREC11 30-class mesh classification: the counterpart of
experiments/classification_shrec11/classification_shrec11.py, the
reference's configuration (C_width 64, 4 blocks, outputs at global_mean,
dropout off, label smoothing 0.2, Adam 1e-3 halved every 50 epochs, random
rotations for xyz features; a random split_size-per-class train split with
a disjoint test set, drawn anew each run, so no pretrained model ships).

    python -m diffusionnet_tpu_torch.experiments.classification_shrec11.classification_shrec11 \
        --input_features hks --dataset_type simplified [--megakernel] \
        [--device cuda] [--data_dir DIR]

The data is what experiments/classification_shrec11/prepare_data.py lays
out.
"""

from __future__ import annotations

import argparse
import os

from ..exp_common import (FitConfig, Stopwatch, add_device_arg, build_model,
                          driver_device, fit, suite_dir)
from .shrec11_dataset import (Shrec11MeshDataset_Original,
                              Shrec11MeshDataset_Simplified)

SUITE = "classification_shrec11"


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_features", type=str, default="hks",
                        help="'xyz' or 'hks'")
    parser.add_argument("--dataset_type", type=str, default="original",
                        help="'original' or 'simplified'")
    parser.add_argument("--split_size", type=int, default=10)
    parser.add_argument("--n_epoch", type=int, default=200)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--k_eig", type=int, default=128)
    parser.add_argument("--device_data", action="store_true",
                        help="keep the stacked dataset on the card and "
                             "gather batches there (no per-step host copy)")
    parser.add_argument("--megakernel", action="store_true",
                        help="the blocks on kernels B1/B2")
    parser.add_argument("--resume_from", type=str, default=None,
                        help="checkpoint dir: continue a stopped run")
    parser.add_argument("--bf16", action="store_true",
                        help="bf16 operands, f32 accumulation")
    parser.add_argument("--data_dir", type=str, default=None,
                        help=f"dataset root (default: experiments/{SUITE}/"
                             "data/{dataset_type})")
    parser.add_argument("--model_save_path", type=str, default=None,
                        help="checkpoint base path (default: <data_dir>/"
                             "saved_models/shrec11_<type>_<features>; "
                             "checkpoints land in <path>_ckpt/)")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = driver_device(args.device)

    dataset_path = args.data_dir or os.path.join(suite_dir(SUITE), "data",
                                                 args.dataset_type)
    op_cache_dir = os.path.join(dataset_path, "op_cache")
    cls = {"simplified": Shrec11MeshDataset_Simplified,
           "original": Shrec11MeshDataset_Original}[args.dataset_type]
    sw, stages = Stopwatch(), {}

    with sw("precompute"):
        train_dataset = cls(dataset_path, split_size=args.split_size,
                            k_eig=args.k_eig, op_cache_dir=op_cache_dir,
                            device=device, timings=stages)
        test_dataset = cls(dataset_path, split_size=None, k_eig=args.k_eig,
                           op_cache_dir=op_cache_dir,
                           exclude_dict=train_dataset.entries,
                           device=device, timings=stages)
    cfg = FitConfig(
        n_epoch=args.n_epoch, lr=1e-3, decay_every=50, decay_rate=0.5,
        batch_size=args.batch_size, input_features=args.input_features,
        augment_rotate=(args.input_features == "xyz"),
        label_smoothing=0.2, labels_kind="global",
        use_megakernel=args.megakernel, bf16=args.bf16,
        device_data=args.device_data, graceful_sigterm=True)
    model = build_model(n_class=30, c_width=64, outputs_at="global_mean",
                        dropout=False, input_features=args.input_features,
                        bf16=args.bf16)
    model_save_path = args.model_save_path or os.path.join(
        dataset_path, "saved_models",
        f"shrec11_{args.dataset_type}_{args.input_features}")
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
