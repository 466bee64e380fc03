"""Model zoo of the port (vision: ResNet v1)."""
