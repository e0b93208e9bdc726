from pysteps_tpu_torch.tracking import lucaskanade  # noqa: F401
