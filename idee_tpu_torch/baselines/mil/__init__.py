"""MIL baselines: DeepMIL, ARNet, RTFM, MGFN (counterpart of
idee_tpu/baselines/mil/)."""
