"""Multi-device paths over torch.distributed (counterpart of
kzg_tpu/parallel): the process group and its 1-D mesh (distributed), the
sharded MSM and setup generation (sharded) and the four-step NTT (ntt)."""
