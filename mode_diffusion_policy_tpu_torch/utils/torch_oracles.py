"""The torchvision-layout FiLM-ResNet, the PyTorch half of the checkpoint
fidelity check (counterpart of ``mode_diffusion_policy_tpu/utils/
torch_oracles.py``, the port's own copy).

It builds the standard torchvision-layout ResNet (conv1/bn1/layer{1-4},
the v1.5 bottleneck's stride on the 3x3 conv) from ``torch.nn`` modules,
with state-dict keys equal to those of the timm 'resnet50'/'resnet18'
checkpoints the reference loads (pretrained_resnets.py:29,67,106), timm
itself not being a dependency. ``utils/verify_checkpoint.py`` holds the
port's ``FiLMResNetPolicy`` against it; it is never on a served path.
"""
import torch
import torch.nn as nn


class TorchBasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = downsample

    def forward(self, x):
        idt = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            idt = self.downsample(x)
        return self.relu(out + idt)


class TorchBottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        idt = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            idt = self.downsample(x)
        return self.relu(out + idt)


class TorchResNet(nn.Module):
    def __init__(self, block, layers):
        super().__init__()
        self.inplanes = 64
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], 2)
        self.layer3 = self._make_layer(block, 256, layers[2], 2)
        self.layer4 = self._make_layer(block, 512, layers[3], 2)

    def _make_layer(self, block, planes, blocks, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2d(self.inplanes, planes * block.expansion, 1, stride,
                          bias=False),
                nn.BatchNorm2d(planes * block.expansion))
        layers = [block(self.inplanes, planes, stride, downsample)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes))
        return nn.Sequential(*layers)

    def forward_trunk(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        return x


def torch_resnet(depth):
    if depth == 18:
        return TorchResNet(TorchBasicBlock, [2, 2, 2, 2])
    if depth == 34:
        return TorchResNet(TorchBasicBlock, [3, 4, 6, 3])
    if depth == 50:
        return TorchResNet(TorchBottleneck, [3, 4, 6, 3])
    raise ValueError(depth)


class TorchFiLMLayer(nn.Module):
    """reference pretrained_resnets.py:5-23"""

    def __init__(self, num_features, condition_dim, zero_init=True):
        super().__init__()
        self.gamma = nn.Linear(condition_dim, num_features)
        self.beta = nn.Linear(condition_dim, num_features)
        if zero_init:
            nn.init.zeros_(self.gamma.weight)
            nn.init.zeros_(self.gamma.bias)
            nn.init.zeros_(self.beta.weight)
            nn.init.zeros_(self.beta.bias)

    def forward(self, x, condition):
        gamma = self.gamma(condition).unsqueeze(2).unsqueeze(3)
        beta = self.beta(condition).unsqueeze(2).unsqueeze(3)
        return (1 + gamma) * x + beta


class TorchFiLMResNetPolicy(nn.Module):
    """reference FiLMResNet50Policy/34/18 (pretrained_resnets.py:25-138),
    with random (non-zero) FiLM weights so the test exercises the path."""

    def __init__(self, condition_dim, depth=50, zero_film=False):
        super().__init__()
        self.resnet = torch_resnet(depth)
        exp = 4 if depth == 50 else 1
        self.film1 = TorchFiLMLayer(64 * exp, condition_dim, zero_film)
        self.film2 = TorchFiLMLayer(128 * exp, condition_dim, zero_film)
        self.film3 = TorchFiLMLayer(256 * exp, condition_dim, zero_film)
        self.film4 = TorchFiLMLayer(512 * exp, condition_dim, zero_film)

    def forward(self, x, condition):
        if condition.dim() == 3:
            condition = condition.squeeze(1)
        x = self.resnet.forward_trunk(x)
        x = self.film1(self.resnet.layer1(x), condition)
        x = self.film2(self.resnet.layer2(x), condition)
        x = self.film3(self.resnet.layer3(x), condition)
        x = self.film4(self.resnet.layer4(x), condition)
        return x.mean(dim=(2, 3))
