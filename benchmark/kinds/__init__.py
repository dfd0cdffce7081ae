"""Drivers, one a kind of work (training steps, search requests), each found
by the name a traffic file gives under "driver"."""
