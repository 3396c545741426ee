"""Knowledge distillation (port of quant_tpu/train/kd.py).

loss = KL(softmax(teacher/T) || softmax(student/T)) * T^2, summed over
classes, averaged over the batch. The reference's teacher correction
compares the teacher's prediction with itself (a no-op, with which its
published numbers were made); that stays the default, and
`fixed_teacher_correction` compares it with the target instead.
"""

from typing import Callable

import torch

from quant_tpu_torch.nn.layers import state_unchanged


def kd_criterion(output_student: torch.Tensor,
                 output_teacher: torch.Tensor,
                 target: torch.Tensor,
                 temperature: float,
                 freeze_teacher: bool = True,
                 teacher_correction: bool = True,
                 fixed_teacher_correction: bool = False) -> torch.Tensor:
    """KD loss over raw logits of student and teacher."""
    t = temperature
    teacher_val = (output_teacher.detach() if freeze_teacher
                   else output_teacher)
    log_p_student = torch.log_softmax(output_student / t, dim=1)
    p_teacher = torch.softmax(teacher_val / t, dim=1)
    log_p_teacher = torch.log_softmax(teacher_val / t, dim=1)
    kd = (p_teacher * (log_p_teacher - log_p_student)).sum(dim=1) * (t * t)
    if teacher_correction and fixed_teacher_correction:
        correct = teacher_val.argmax(dim=1) == target
        logp = torch.log_softmax(output_student, dim=1)
        ce = -torch.gather(logp, 1, target[:, None])[:, 0]
        kd = torch.where(correct, kd, ce)
    return kd.mean()


def make_teacher_apply(teacher: torch.nn.Module,
                       train_mode: bool = False) -> Callable:
    """A frozen teacher's forward, (data) -> logits, the counterpart of
    the JAX task's teacher_apply (quant_tpu/train/task.py:129-135).

    It runs under torch.no_grad (JAX's stop_gradient; the teacher's
    parameters are constants of the student's step either way). With
    `train_mode` the teacher runs its train forward (BN on the batch's
    statistics, as the recipes ask) and its state is put back after
    each call, as JAX throws the mutated collections away; else its eval
    forward. A teacher_dtype is the teacher's train_dtype and eval_dtype,
    set on the model before. A teacher banded like the student
    (parallel.band_model over the same mesh) takes the same row band:
    its train-mode statistics reduce over 'space', and with no gradient
    recorded its stem pool runs the pool kernel on its band.
    """
    def apply(data: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            if not train_mode:
                return teacher.eval()(data)
            with state_unchanged(teacher):
                return teacher.train()(data)
    return apply
