"""The S²FL core: round driver, sliding scheduler, balance groups,
Algorithm-1 aggregation and the round engine."""
