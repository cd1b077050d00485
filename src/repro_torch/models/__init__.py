"""The model stack of the port: configuration, parameter specs, layers and
the families it runs (dense transformer, RWKV6), entered by
:func:`repro_torch.models.model.build`; and the shape tables of every
registry family, counted by :func:`repro_torch.models.model.num_params`."""
