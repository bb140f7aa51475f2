"""The port's hand-written Hopper kernels, their plain versions and the
dispatch (port of ``repro.kernels``).  Kernels are built on first use."""
