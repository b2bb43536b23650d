"""dispatch_host_ms.ag: dispatch_host_ms.serve's reading, in the gated net's cell."""

import harness

read = harness.metric_reader("dispatch_host_ms.serve")
