"""Training substrate of the port.  So far only the straggler watchdog
(:mod:`repro_torch.training.fault`), which the serving engine feeds its
tick times; the trainer, optimizer and checkpointing are queued in
ROADMAP.md Queue 1 ('LM stack, still to port')."""
