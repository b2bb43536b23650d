"""copy_in_host_ms.ag: copy_in_host_ms.serve's reading, in the gated net's cell."""

import harness

read = harness.metric_reader("copy_in_host_ms.serve")
