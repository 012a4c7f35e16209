"""Models of the port: the ResNet stamp classifiers (cnn)."""
