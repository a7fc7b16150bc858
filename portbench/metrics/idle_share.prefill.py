"""Share of the traced window in which no kernel ran on the card, %."""
from portbench.metrics_common import idle_share as read  # noqa: F401
