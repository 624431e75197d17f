"""Several processes with ``torch.distributed`` (port of
vidsitu_tpu/parallel): rank helpers and reductions (``collectives``), the
process group, each rank's device and the 1-D ``data`` mesh (``mesh``)."""
