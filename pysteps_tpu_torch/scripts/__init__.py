"""Analysis scripts (reference: pysteps/scripts/): velocity-perturbation
parameter estimation for the BPS2006 motion perturbator."""
