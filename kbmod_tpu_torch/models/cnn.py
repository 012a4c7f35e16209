"""ResNet stamp classifiers in PyTorch (CNN vetting).

Port of the JAX package's models/cnn.py (flax). The reference vets
coadded stamps with torchvision resnet18/resnet50 whose first conv is
rewired to 1 input channel and whose head outputs 2 classes (real / bogus)
(src/kbmod/filters/stamp_filters.py:27-69). The modules here are written
out by hand with torchvision's layout and parameter names (no torchvision
import), so a torchvision-style ``state_dict`` loads as it stands, with or
without the reference wrapper's ``model.`` prefix; ``convert_flax_params``
carries the JAX package's flax parameters across.

``StampClassifier`` runs in eval mode on its device (CUDA unless
``device="cpu"``), in float32 with TF32 off. The convolutions are cuDNN's
(``nn.Conv2d``): the reference runs them in XLA, outside any Pallas kernel.
"""

import numpy as np
import torch
from torch import nn

from kbmod_tpu_torch.device import resolve_device

# Stamps one forward pass takes at most (eval mode: the logits do not
# depend on the batch).
PREDICT_BATCH = 4096


class BasicBlock(nn.Module):
    """ResNet v1 basic block (3x3 + 3x3) with projection shortcut."""

    expansion = 1

    def __init__(self, in_planes, planes, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = _projection(in_planes, planes, stride)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return torch.relu(out + identity)


class Bottleneck(nn.Module):
    """ResNet v1 bottleneck block (1x1, 3x3, 1x1) with expansion 4."""

    expansion = 4

    def __init__(self, in_planes, planes, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = _projection(in_planes, planes * 4, stride)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return torch.relu(out + identity)


def _projection(in_planes, out_planes, stride):
    """torchvision's ``downsample``: a strided 1x1 conv and a BatchNorm
    where the block changes the shape, else None."""
    if stride == 1 and in_planes == out_planes:
        return None
    return nn.Sequential(nn.Conv2d(in_planes, out_planes, 1, stride, bias=False), nn.BatchNorm2d(out_planes))


class ResNet(nn.Module):
    """ResNet v1 for single-channel stamps with ``num_classes`` outputs;
    input (N, 1, H, W)."""

    def __init__(self, stage_sizes, block_cls, num_classes=2):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.block_cls = block_cls
        self.conv1 = nn.Conv2d(1, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        in_planes, planes = 64, 64
        for stage, num_blocks in enumerate(self.stage_sizes):
            blocks = []
            for b in range(num_blocks):
                blocks.append(block_cls(in_planes, planes, 2 if stage > 0 and b == 0 else 1))
                in_planes = planes * block_cls.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
            planes *= 2
        self.fc = nn.Linear(in_planes, num_classes)

    def forward(self, x):
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        for stage in range(len(self.stage_sizes)):
            x = getattr(self, f"layer{stage + 1}")(x)
        return self.fc(x.mean(dim=(2, 3)))


def resnet18(num_classes=2):
    return ResNet((2, 2, 2, 2), BasicBlock, num_classes)


def resnet34(num_classes=2):
    return ResNet((3, 4, 6, 3), BasicBlock, num_classes)


def resnet50(num_classes=2):
    return ResNet((3, 4, 6, 3), Bottleneck, num_classes)


MODEL_TYPES = {
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
}


def _random_init(model, generator):
    """torchvision's initialisation, drawn from ``generator``: convs
    kaiming-normal (fan out, relu), BatchNorm scale 1 and shift 0, the
    head uniform in +-1/sqrt(fan in)."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Conv2d):
                fan_out = mod.out_channels * mod.kernel_size[0] * mod.kernel_size[1]
                mod.weight.normal_(0.0, float(np.sqrt(2.0 / fan_out)), generator=generator)
            elif isinstance(mod, nn.BatchNorm2d):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, nn.Linear):
                bound = 1.0 / float(np.sqrt(mod.in_features))
                mod.weight.uniform_(-bound, bound, generator=generator)
                mod.bias.uniform_(-bound, bound, generator=generator)


def strip_wrapper_prefix(state):
    """A state_dict without the reference wrapper's ``model.`` prefix."""
    return {(k[len("model."):] if k.startswith("model.") else k): v for k, v in state.items()}


class StampClassifier:
    """A stamp classifier: a ResNet and its weights, in eval mode on
    ``device``, with an inference method over stamp batches.

    Parameters
    ----------
    model_type : str
        One of MODEL_TYPES.
    stamp_width : int
        The input stamp width (stamps are (width, width)).
    model_path : str or None
        Weights file: a ``.npz`` archive of the JAX package's flax
        parameters (its ``StampClassifier.save_weights``), or anything else
        ``torch.load`` reads: a torchvision-style state_dict (``model.``
        prefix allowed) or a module holding one. None draws a random
        (untrained) initialisation from ``torch.Generator`` seeded with
        ``seed``.
    device : str or torch.device or None
        Where the model runs: None means CUDA, "cpu" the host.
    """

    def __init__(self, model_type="resnet18", stamp_width=21, model_path=None, seed=0, device=None):
        if model_type not in MODEL_TYPES:
            raise ValueError(f"Unknown CNN model type {model_type}")
        self.device = resolve_device(device)
        self.stamp_width = stamp_width
        self.model = MODEL_TYPES[model_type](num_classes=2)
        if model_path:
            self.load_weights(model_path)
        else:
            _random_init(self.model, torch.Generator().manual_seed(int(seed)))
        self.model.to(self.device).eval()

    def load_weights(self, model_path):
        """Load a flax ``.npz`` archive or a torch checkpoint (see the class
        docstring) into the model."""
        path = str(model_path)
        if path.endswith(".npz"):
            flat = dict(np.load(path))
            params = _unflatten({k[len("params/"):]: v for k, v in flat.items() if k.startswith("params/")})
            stats = _unflatten({k[len("batch_stats/"):]: v for k, v in flat.items() if k.startswith("batch_stats/")})
            state = convert_flax_params(params, stats, self.model.stage_sizes, self.model.block_cls)
        else:
            state = torch.load(path, map_location="cpu", weights_only=False)
            if hasattr(state, "state_dict"):
                state = state.state_dict()
            state = {k: torch.as_tensor(np.asarray(v)) for k, v in state.items()}
        self.load_state_dict(state)

    def load_state_dict(self, state):
        """Load a torchvision-style state_dict (``model.`` prefix allowed;
        BatchNorm ``num_batches_tracked`` entries optional)."""
        state = strip_wrapper_prefix(state)
        missing, unexpected = self.model.load_state_dict(state, strict=False)
        missing = [k for k in missing if not k.endswith("num_batches_tracked")]
        if missing or unexpected:
            raise ValueError(f"CNN weights do not fit the model: missing {missing}, unexpected {unexpected}")

    def save_weights(self, model_path):
        """Write the weights as the JAX package's ``.npz`` archive (flat
        ``params/...`` and ``batch_stats/...`` keys of its flax trees), which
        both packages' ``load_weights`` read."""
        state = {k: v.detach().cpu().numpy() for k, v in self.model.state_dict().items()}
        params, stats = to_flax_params(state, self.model.stage_sizes, self.model.block_cls)
        flat = {f"params/{k}": v for k, v in _flatten(params).items()}
        flat.update({f"batch_stats/{k}": v for k, v in _flatten(stats).items()})
        np.savez(model_path, **flat)

    def predict(self, stamps):
        """stamps: (N, W, W) or (N, 1, W, W) float array. Returns (N, 2)
        logits as numpy."""
        stamps = np.asarray(stamps, dtype=np.float32)
        if stamps.ndim == 3:
            stamps = stamps[:, None]
        out = []
        with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            for lo in range(0, len(stamps), PREDICT_BATCH):
                x = torch.as_tensor(stamps[lo : lo + PREDICT_BATCH], device=self.device)
                out.append(self.model(x).cpu().numpy())
        return np.concatenate(out) if out else np.zeros((0, 2), dtype=np.float32)


def convert_flax_params(params, batch_stats, stage_sizes, block_cls):
    """The torchvision-style state_dict (torch tensors) of the JAX package's
    flax ResNet ``(params, batch_stats)`` trees of numpy arrays: the inverse
    of its ``convert_torch_state_dict``.

    Flax HWIO conv kernels become OIHW, ``Dense_0`` is transposed into
    ``fc``, and BatchNorm scale, bias, mean and var become weight, bias,
    running_mean and running_var. Blocks are numbered ``BasicBlock_i`` or
    ``Bottleneck_i`` across stages, their convs ``Conv_0``.. in order with
    the projection (torchvision's ``downsample``) as the last ``Conv_n``.
    """
    state = {}

    def conv(dst, p):
        state[dst + ".weight"] = np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))

    def bn(dst, p, s):
        state[dst + ".weight"] = np.asarray(p["scale"])
        state[dst + ".bias"] = np.asarray(p["bias"])
        state[dst + ".running_mean"] = np.asarray(s["mean"])
        state[dst + ".running_var"] = np.asarray(s["var"])
        state[dst + ".num_batches_tracked"] = np.zeros((), dtype=np.int64)

    conv("conv1", params["Conv_0"])
    bn("bn1", params["BatchNorm_0"], batch_stats["BatchNorm_0"])
    n_convs = 3 if block_cls is Bottleneck else 2
    block_name = "Bottleneck" if block_cls is Bottleneck else "BasicBlock"
    block_idx = 0
    for stage, num_blocks in enumerate(stage_sizes):
        for b in range(num_blocks):
            dst = f"layer{stage + 1}.{b}"
            name = f"{block_name}_{block_idx}"
            bp, bs = params[name], batch_stats[name]
            for c in range(n_convs):
                conv(f"{dst}.conv{c + 1}", bp[f"Conv_{c}"])
                bn(f"{dst}.bn{c + 1}", bp[f"BatchNorm_{c}"], bs[f"BatchNorm_{c}"])
            if f"Conv_{n_convs}" in bp:
                conv(f"{dst}.downsample.0", bp[f"Conv_{n_convs}"])
                bn(f"{dst}.downsample.1", bp[f"BatchNorm_{n_convs}"], bs[f"BatchNorm_{n_convs}"])
            block_idx += 1
    state["fc.weight"] = np.asarray(params["Dense_0"]["kernel"]).T
    state["fc.bias"] = np.asarray(params["Dense_0"]["bias"])
    return {k: torch.as_tensor(np.ascontiguousarray(v)) for k, v in state.items()}


def to_flax_params(state, stage_sizes, block_cls):
    """The JAX package's flax ``(params, batch_stats)`` trees of numpy arrays
    from a torchvision-style state_dict of numpy arrays: the inverse of
    :func:`convert_flax_params` (a copy of the JAX package's
    ``convert_torch_state_dict``, numpy in place of jax arrays). OIHW convs
    become HWIO, ``fc`` becomes the transposed ``Dense_0``; BatchNorm's
    ``num_batches_tracked`` has no flax counterpart and is dropped."""
    state = {k: np.asarray(v) for k, v in strip_wrapper_prefix(state).items()}

    def conv(key):
        return {"kernel": np.ascontiguousarray(np.transpose(state[key + ".weight"], (2, 3, 1, 0)))}

    def bn(key):
        p = {"scale": state[key + ".weight"], "bias": state[key + ".bias"]}
        s = {"mean": state[key + ".running_mean"], "var": state[key + ".running_var"]}
        return p, s

    params, stats = {}, {}
    params["Conv_0"] = conv("conv1")
    params["BatchNorm_0"], stats["BatchNorm_0"] = bn("bn1")
    n_convs = 3 if block_cls is Bottleneck else 2
    block_name = "Bottleneck" if block_cls is Bottleneck else "BasicBlock"
    block_idx = 0
    for stage, num_blocks in enumerate(stage_sizes):
        for b in range(num_blocks):
            src = f"layer{stage + 1}.{b}"
            bp, bs = {}, {}
            for c in range(n_convs):
                bp[f"Conv_{c}"] = conv(f"{src}.conv{c + 1}")
                bp[f"BatchNorm_{c}"], bs[f"BatchNorm_{c}"] = bn(f"{src}.bn{c + 1}")
            if f"{src}.downsample.0.weight" in state:
                bp[f"Conv_{n_convs}"] = conv(f"{src}.downsample.0")
                bp[f"BatchNorm_{n_convs}"], bs[f"BatchNorm_{n_convs}"] = bn(f"{src}.downsample.1")
            name = f"{block_name}_{block_idx}"
            params[name], stats[name] = bp, bs
            block_idx += 1
    params["Dense_0"] = {"kernel": np.ascontiguousarray(state["fc.weight"].T), "bias": state["fc.bias"]}
    return params, stats


def _flatten(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_flatten(value, name + "/"))
        else:
            out[name] = np.asarray(value)
    return out


def _unflatten(flat):
    tree = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree
