"""The HopVAE model and its conv stacks."""
