"""Kubelet plugins of the GPU port."""
