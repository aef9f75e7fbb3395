"""The command-line entry points: `python -m cocosnet_tpu_torch.cli.test`
and `python -m cocosnet_tpu_torch.cli.train`, flag for flag the twins of
the repository's test.py and train.py."""
