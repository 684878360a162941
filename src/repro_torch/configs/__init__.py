"""Model configurations: ``ModelConfig``, the input shapes and one file per
architecture with its published hyper-parameters (``registry.get_config``)."""
