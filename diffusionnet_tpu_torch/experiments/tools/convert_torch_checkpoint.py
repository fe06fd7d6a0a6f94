"""Convert a reference PyTorch DiffusionNet state_dict (.pth) into the
JAX-layout parameters that both packages load: the counterpart of
experiments/tools/convert_torch_checkpoint.py.

The reference ships pretrained checkpoints (human_segmentation {xyz,hks}
4x128, functional_correspondence {faust,scape}x{xyz,hks}); converted, they
give the drivers' --evaluate flows the reference's weights.

    python -m diffusionnet_tpu_torch.experiments.tools.convert_torch_checkpoint \
        IN.pth OUT.npz [--n_block 4] [--fmaps]

OUT.npz holds the same keys and arrays as the JAX tool writes
(`first_lin/kernel`, `block_0/mlp/dense_000/bias`, ... under
`feature_extractor/` with --fmaps). In memory the loaders return the port's
flat params: those keys under `params/`, the layout that
`models.from_flat_jax_params` and `fit(params=...)` take.

Weight mapping: torch Linear.weight (out, in) -> Dense kernel (in, out);
module paths block_i/diffusion/diffusion_time,
block_i/gradient_features/A_re|A_im, block_i/mlp/dense_00k, first_lin,
last_lin, with feature_extractor/ ahead of them for the functional-maps
model.
"""

from __future__ import annotations

import argparse

import numpy as np

_FMAPS = "feature_extractor."


def convert_state_dict(sd: dict, n_block: int, prefix: str = "") -> dict:
    """torch state_dict (name -> numpy array) -> the port's flat params
    (`params/first_lin/kernel`, ...). prefix: the state_dict's name prefix
    of the DiffusionNet ('feature_extractor.' for the functional-maps
    model); it becomes `feature_extractor/` in the keys."""
    out_prefix = "params/" + prefix.replace(".", "/")
    flat: dict = {}

    def dense(tname, key):
        flat[out_prefix + key + "/kernel"] = sd[tname + ".weight"].T.copy()
        if tname + ".bias" in sd:
            flat[out_prefix + key + "/bias"] = sd[tname + ".bias"].copy()

    dense(prefix + "first_lin", "first_lin")
    dense(prefix + "last_lin", "last_lin")
    for b in range(n_block):
        tb = f"{prefix}block_{b}"
        fb = f"block_{b}/"
        flat[out_prefix + fb + "diffusion/diffusion_time"] = (
            sd[tb + ".diffusion.diffusion_time"].copy())
        for name in ("A_re", "A_im", "A"):
            key = f"{tb}.gradient_features.{name}.weight"
            if key in sd:
                flat[out_prefix + fb + f"gradient_features/{name}/kernel"] = (
                    sd[key].T.copy())
        mlp_keys = sorted(k for k in sd
                          if k.startswith(tb + ".mlp.") and k.endswith(".weight"))
        for i, wk in enumerate(mlp_keys):
            dense(wk[:-len(".weight")], fb + f"mlp/dense_{i:03d}")
    return flat


def _infer_n_block(sd: dict, prefix: str = "") -> int:
    """Number of DiffusionNet blocks from state_dict key names."""
    blocks = set()
    for k in sd:
        if k.startswith(prefix + "block_"):
            blocks.add(int(k[len(prefix + "block_"):].split(".")[0]))
    if not blocks:
        raise ValueError("no block_i.* keys found — not a reference "
                         "DiffusionNet state_dict")
    return max(blocks) + 1


def load_converted(path: str) -> dict:
    """An .npz written by this tool (or the JAX tool) -> the port's flat
    params."""
    with np.load(path) as npz:
        return {"params/" + k: npz[k] for k in npz.files}


def _read_state_dict(path: str) -> dict:
    import torch
    sd_t = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd_t, dict):
        raise ValueError(f"{path}: expected a state_dict, got {type(sd_t)}")
    return {k: v.detach().numpy() for k, v in sd_t.items()}


def load_reference_checkpoint(path: str, n_block: int | None = None,
                              fmaps: bool = False) -> dict:
    """Reference DiffusionNet weights -> the port's flat params.

    Accepts an .npz written by this converter, or the reference's torch
    .pth checkpoint itself (converted in memory). n_block defaults to what
    the state_dict's key names imply. fmaps: the checkpoint is a
    functional-maps model (DiffusionNet under `feature_extractor.`,
    reference fmaps_model.py)."""
    if path.endswith(".npz"):
        return load_converted(path)
    sd = _read_state_dict(path)
    prefix = _FMAPS if fmaps else ""
    if n_block is None:
        n_block = _infer_n_block(sd, prefix)
    return convert_state_dict(sd, n_block, prefix=prefix)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--n_block", type=int, default=4)
    ap.add_argument("--fmaps", action="store_true",
                    help="checkpoint is a functional-maps model (feature "
                         "extractor nested under feature_extractor.)")
    args = ap.parse_args(argv)

    sd = _read_state_dict(args.input)
    flat = convert_state_dict(sd, args.n_block,
                              prefix=_FMAPS if args.fmaps else "")
    flat = {k[len("params/"):]: v for k, v in flat.items()}
    np.savez(args.output, **flat)
    print(f"wrote {args.output}: {len(flat)} arrays, "
          f"{sum(v.size for v in flat.values())} params")
    return flat


if __name__ == "__main__":
    main()
