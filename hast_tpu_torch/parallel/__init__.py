"""Multi-device and multi-process paths of the port."""
