"""Hand-written CUDA kernels (sources in ``repro_torch/csrc``), each with a
plain PyTorch version beside it and a launch counter on its wrapper."""


def launch_counts() -> dict:
    """This process's kernel launches so far, by kernel name (the wrappers'
    counters; a plain-version call on a CPU tensor counts nothing)."""
    from repro_torch.kernels.idl_insert import kernel as ins_kernel
    from repro_torch.kernels.idl_locations import kernel as loc_kernel
    from repro_torch.kernels.idl_probe import kernel as probe_kernel
    from repro_torch.kernels.window_min import kernel as wm_kernel

    return {probe_kernel.NAME: probe_kernel.launches,
            probe_kernel.BIT_MODE_NAME: probe_kernel.bit_mode_launches,
            probe_kernel.BITS_NAME: probe_kernel.bits_launches,
            ins_kernel.NAME: ins_kernel.launches,
            ins_kernel.ROUNDS_NAME: ins_kernel.round_launches,
            wm_kernel.NAME: wm_kernel.launches,
            loc_kernel.NAME32: loc_kernel.launches32,
            loc_kernel.NAME64: loc_kernel.launches64}
