"""The paper's algorithm-comparison figures on the port (figs 3, 4, 7),
and the statistical band that holds the port's training runs to the JAX
package's (:mod:`repro_torch.figures.band`)."""
