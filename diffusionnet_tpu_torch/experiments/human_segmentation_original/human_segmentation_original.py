"""Human segmentation (8 classes per face) on the Maron et al. dataset: the
counterpart of experiments/human_segmentation_original/
human_segmentation_original.py, the reference's configuration (C_width 128,
4 blocks, outputs at faces, dropout on, HKS features by default, Adam 1e-3
halved every 50 epochs).

    python -m diffusionnet_tpu_torch.experiments.human_segmentation_original.human_segmentation_original \
        [--input_features hks] [--megakernel] [--device cuda] \
        [--evaluate [--load_model PATH]] [--data_dir DIR]

The data is what experiments/human_segmentation_original/prepare_data.py
lays out. --evaluate without --load_model takes the converted reference
weights in pretrained_models/; --load_model also takes a .pth, a converted
.npz, or a checkpoint of fit (a step file or its _ckpt directory).
"""

from __future__ import annotations

import argparse
import os

from ..exp_common import (FitConfig, Stopwatch, add_device_arg, build_model,
                          driver_device, fit, load_weights, make_evaluate,
                          suite_dir)
from .human_segmentation_original_dataset import HumanSegOrigDataset

SUITE = "human_segmentation_original"


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--evaluate", action="store_true")
    parser.add_argument("--load_model", type=str, default=None)
    parser.add_argument("--input_features", type=str, default="hks")
    parser.add_argument("--n_epoch", type=int, default=200)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--k_eig", type=int, default=128)
    parser.add_argument("--device_data", action="store_true",
                        help="keep the stacked dataset on the card and "
                             "gather batches there (no per-step host copy)")
    parser.add_argument("--megakernel", action="store_true",
                        help="the blocks on kernels B1/B2")
    parser.add_argument("--resume_from", type=str, default=None,
                        help="checkpoint dir: continue a stopped run")
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--data_dir", type=str, default=None,
                        help="dataset root (default: experiments/"
                             f"{SUITE}/data/sig17_seg_benchmark)")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = driver_device(args.device)

    base_path = suite_dir(SUITE)
    pretrain_path = os.path.join(
        base_path, "pretrained_models",
        f"human_seg_{args.input_features}_4x128.npz")
    dataset_path = args.data_dir or os.path.join(base_path, "data",
                                                 "sig17_seg_benchmark")
    op_cache_dir = os.path.join(dataset_path, "op_cache")
    model_save_path = os.path.join(
        dataset_path, "saved_models",
        f"human_seg_{args.input_features}_4x128")
    sw, stages = Stopwatch(), {}

    with sw("precompute"):
        test_dataset = HumanSegOrigDataset(
            dataset_path, train=False, k_eig=args.k_eig,
            op_cache_dir=op_cache_dir, device=device, timings=stages)
    cfg = FitConfig(
        n_epoch=args.n_epoch, lr=1e-3, decay_every=50, decay_rate=0.5,
        batch_size=args.batch_size, input_features=args.input_features,
        augment_rotate=(args.input_features == "xyz"), labels_kind="face",
        use_megakernel=args.megakernel, bf16=args.bf16,
        device_data=args.device_data, graceful_sigterm=True)
    model = build_model(n_class=8, c_width=128, outputs_at="faces",
                        dropout=True, input_features=args.input_features,
                        bf16=args.bf16)
    result = {"model_save_path": model_save_path}

    if args.evaluate:
        if not args.load_model and os.path.exists(pretrain_path):
            args.load_model = pretrain_path  # converted reference weights
        if not args.load_model:
            raise ValueError("--evaluate requires --load_model")
        params = load_weights(args.load_model, model, device)
        eval_cfg = FitConfig(batch_size=cfg.batch_size,
                             input_features=cfg.input_features,
                             labels_kind="face")
        evaluate, _ = make_evaluate(model, eval_cfg, device)
        with sw("evaluate"):
            acc = evaluate(params, test_dataset)
        print(f"Overall test accuracy: {100 * acc:06.3f}%")
        return dict(result, test_acc=acc, seconds=sw.seconds,
                    precompute_stages=stages)

    with sw("precompute"):
        train_dataset = HumanSegOrigDataset(
            dataset_path, train=True, k_eig=args.k_eig,
            op_cache_dir=op_cache_dir, device=device, timings=stages)
    with sw("fit"):
        params, history, evaluate = fit(
            model, train_dataset, test_dataset, cfg,
            model_save_path=model_save_path,
            log_path=model_save_path + "_log.jsonl",
            resume_from=args.resume_from, device=device)
    with sw("evaluate"):
        acc = evaluate(params, test_dataset)
    print(f"Overall test accuracy: {100 * acc:06.3f}%")
    return dict(result, test_acc=acc, history=history, seconds=sw.seconds,
                precompute_stages=stages)


if __name__ == "__main__":
    main()
