"""Synthetic datasets and the Dirichlet federated split."""
