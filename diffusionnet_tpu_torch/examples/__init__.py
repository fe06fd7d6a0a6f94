"""Examples that need no download, run as modules:
`python -m diffusionnet_tpu_torch.examples.synthetic_shrec`."""
