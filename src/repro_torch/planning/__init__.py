"""Cost modelling (counterpart of ``repro.planning``).

So far only the online least-squares fit the serving engine runs over its
tick times (:mod:`repro_torch.planning.lsq`); the calibrated cost model
and the plan autotuner are queued in ROADMAP.md Queue 1, 'planning/'.
"""
