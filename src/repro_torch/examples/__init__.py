"""The reference's four examples on the port, each run as a module:

  PYTHONPATH=src python -m repro_torch.examples.quickstart
  PYTHONPATH=src python -m repro_torch.examples.paper_repro --rounds 100
  PYTHONPATH=src python -m repro_torch.examples.federated_lm
  PYTHONPATH=src python -m repro_torch.examples.serve_decode

Each takes ``--device`` (``cuda`` by default, which raises without a
card; ``cpu`` when asked)."""
