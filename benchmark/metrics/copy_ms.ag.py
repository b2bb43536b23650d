"""copy_ms.ag: copy_ms.serve's reading, in the gated net's cell."""

import harness

read = harness.metric_reader("copy_ms.serve")
