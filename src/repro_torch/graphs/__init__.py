"""Graph engine: packed CEP chunks on the device and the GAS apps over them."""
