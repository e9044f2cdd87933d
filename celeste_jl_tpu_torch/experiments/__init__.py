"""Science runners of the port: the MCMC-vs-VI experiment and its
figures (the port's counterparts of experiments/)."""
