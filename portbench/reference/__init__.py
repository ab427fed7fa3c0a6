"""The plain reference: float32 PyTorch, TF32 off, no kernels.

It follows the published equations of the priors, the UNet, the losses
and the optimizers (torch.optim's Adam and Adamax, ReduceLROnPlateau's
first steps), and imports nothing of the port or of the JAX package. It
receives the inputs and weights the benchmark made and works out again
whatever the port derives from them (norm statistics, point weights,
class weights)."""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
