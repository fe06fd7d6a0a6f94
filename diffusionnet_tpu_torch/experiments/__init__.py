"""The experiments: the harness (`exp_common`: `fit`, the evaluation and
the drivers' shared pieces), the five suites' dataset modules and drivers
(`<suite>.<driver>`, each run as
`python -m diffusionnet_tpu_torch.experiments.<suite>.<driver>`), the
reference-checkpoint converter (`tools.convert_torch_checkpoint`) and each
suite's on-disk layout written from synthetic meshes (`layouts`)."""
