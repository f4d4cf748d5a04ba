"""The port's probes: command-line programs that time a kernel or a
training step of the port on the card (``python -m whisper_flamingo_tpu_torch.tools.<name>``)."""
