"""Multi-VFO channelizer."""
