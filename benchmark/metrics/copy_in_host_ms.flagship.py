"""copy_in_host_ms.flagship: copy_in_host_ms.serve's reading, in the cell that
reports flagship_mpix_s."""

import harness

read = harness.metric_reader("copy_in_host_ms.serve")
