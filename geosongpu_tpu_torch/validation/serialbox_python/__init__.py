"""A directory to point SERIALBOX_PYTHON at where serialbox is not
installed (the card's machine, these hosts): its `serialbox` module reads
Serialbox-2 binary dump directories through validation/serialbox_binary.py,
so `geosongpu-tpu-torch-validation serialbox` converts them."""
