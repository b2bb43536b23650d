"""mfu.ag: mfu.serve's reading, in the gated net's cell."""

import harness

read = harness.metric_reader("mfu.serve")
