"""Command-line tools of the port: ``python -m abnet3_torch.tools.embed_cli``
re-embeds features with trained weights."""
