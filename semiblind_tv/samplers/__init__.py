from semiblind_tv.samplers.myula import myula_kernel_step, myula_sampler  # noqa: F401
