"""Plain reference of an LD job: the pair set of the band walk (with the
GSL taus draws of --rnd_sample), the genotype preprocessing, the pair EM,
Pearson r2 of E[G] and the LD statistics, in NumPy and plain PyTorch.

It reads the same input files as the program and imports nothing of the
program (nor jax, nor ngsld_tpu): the generator arithmetic of the taus
RNG is a frozen copy, and the EM follows the published recurrence of
ngsLD (Fox et al. 2019; gen_func.cpp haplo_freq / pair_freq_iter)."""
