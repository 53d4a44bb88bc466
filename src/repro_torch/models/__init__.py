"""Model zoo (port of ``repro.models``, which exports no names): the
paper's LR and PMF and the LM stack of the ported architectures."""
